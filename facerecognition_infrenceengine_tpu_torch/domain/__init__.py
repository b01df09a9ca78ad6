"""Domain runtimes over the engine: the live cameras (``cameras``)."""
