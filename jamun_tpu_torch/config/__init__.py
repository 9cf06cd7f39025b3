"""Config composition and instantiation (counterpart of `jamun_tpu/config/`);
`defaults/` is the port's copy of the JAX package's config tree."""

from jamun_tpu_torch.config.compose import apply_overrides, compose, merge, resolve_interpolations
from jamun_tpu_torch.config.instantiate import instantiate, instantiate_dict_cfg, locate, resolve_target
