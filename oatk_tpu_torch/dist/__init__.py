"""Multi-device path of the port: meshes, the hash-owner exchange, the
sharded syncmer collector and the process-sharded host stages."""
from .sharding import make_mesh, sharded_extract_count_step
