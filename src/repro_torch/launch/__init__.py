"""Launchers: the step builders (``launch.steps``) and the train and
serve drivers (``launch.train``, ``launch.serve``)."""
