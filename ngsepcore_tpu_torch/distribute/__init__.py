from .mesh import ReadsMesh, make_reads_mesh, sharded_call_step
