"""The LM layer of the port: the serving passes of the dense, vlm, moe,
hybrid and ssm families and their building blocks."""
from repro_torch.models.kvcache import cache_specs, init_cache
from repro_torch.models.transformer import (ShardEnv, Transformer,
                                            decode_step, encode, init_params,
                                            prefill)

__all__ = ["ShardEnv", "Transformer", "decode_step", "encode", "init_params",
           "prefill", "cache_specs", "init_cache"]
