"""spmd training over ``torch.distributed``: the mesh of data-parallel
and tensor-parallel ranks (``mesh``), the sharding rules of the model
axis (``sharding``), the collectives of the coded reduction and of the
model group (``collectives``) and a local spawner for tests and the
one-card rehearsal (``spawn``).  ``repro_torch.launch.mesh.make_local_mesh``
builds a mesh from ``torchrun``'s environment or a spawned job."""
