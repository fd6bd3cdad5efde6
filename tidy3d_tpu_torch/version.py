"""Version of tidy3d_tpu. Schema version tracks the reference schema we are
compatible with (reference @ v2.7.6) so reference-written files load."""

__version__ = "0.1.0"

# version of the serialization schema we read/write (reference-compatible)
SCHEMA_VERSION = "2.7.6"
