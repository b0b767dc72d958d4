"""The single-host parallel layer: a mesh of torch devices (``mesh``) and
the sharded drivers over it (``sharded``)."""
