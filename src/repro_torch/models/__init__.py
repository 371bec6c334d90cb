"""The LM layer of the port: the training loss and the serving passes of
every family (dense, vlm, moe, hybrid, ssm and audio) and their building
blocks."""
from repro_torch.models.kvcache import cache_specs, init_cache
from repro_torch.models.transformer import (ShardEnv, Transformer,
                                            decode_step, encode, forward_loss,
                                            init_params, prefill)

__all__ = ["ShardEnv", "Transformer", "decode_step", "encode",
           "forward_loss", "init_params", "prefill", "cache_specs",
           "init_cache"]
