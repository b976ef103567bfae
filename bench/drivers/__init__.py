"""One driver per kind of window: ``train`` and ``serve``.  Each has
``run(cell, seed, seconds, trace, device) -> (result, checks)``."""
