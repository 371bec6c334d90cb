from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ArchConfig, ShapeSpec,
                                cell_plan, get_config, model_flops_per_token,
                                reduced_config)

__all__ = ["ARCH_NAMES", "SHAPES", "ArchConfig", "ShapeSpec", "cell_plan",
           "get_config", "model_flops_per_token", "reduced_config"]
