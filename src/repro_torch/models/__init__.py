from repro_torch.models.model import Model, init_cache, make_cache_specs

__all__ = ["Model", "init_cache", "make_cache_specs"]
