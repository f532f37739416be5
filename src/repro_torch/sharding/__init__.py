from repro_torch.sharding.specs import MeshContext, from_mesh

__all__ = ["MeshContext", "from_mesh"]
