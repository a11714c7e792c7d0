"""Data-parallel batching over ``torch.distributed``: the mesh and sharding
helpers (:mod:`.sharding`) and the multi-device dry run (:mod:`.dryrun`).
Importing it starts no process group."""
