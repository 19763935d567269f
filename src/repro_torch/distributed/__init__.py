"""Distribution on ``torch.distributed``: the per-mode sharding rules
(``sharding``), the compressed all-reduce (``compression``) and the GPipe
pipeline (``pipeline``), over the meshes of ``repro_torch.launch.mesh``."""
