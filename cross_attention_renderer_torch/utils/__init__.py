"""Image utilities, metrics, profiling and ``params_io`` (flat ``.npz``
parameter files)."""
