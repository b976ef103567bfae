"""Hand-written Hopper kernels with their wrappers and plain versions
(``flash_attention``), the layout wrappers (``ops``), the torch oracles
(``ref``) and the stdlib tile registry (``variants``)."""
