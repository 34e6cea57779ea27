"""spmd training over ``torch.distributed``: the mesh of data-parallel
ranks (``mesh``), the collectives of the coded reduction
(``collectives``) and a local spawner for tests and the one-card
rehearsal (``spawn``).  ``repro_torch.launch.mesh.make_local_mesh``
builds a mesh from ``torchrun``'s environment or a spawned job."""
