"""Config registry: the 10 assigned architectures + the paper's own zoo."""
from repro_torch.configs import (deepseek_7b, granite_moe_3b, hymba_1_5b,
                           internvl2_76b, mixtral_8x22b, olmo_1b, paper_zoo,
                           phi4_mini_3_8b, seamless_m4t_large, starcoder2_3b,
                           xlstm_125m)
from repro_torch.configs.base import (SHAPES, ArchConfig, EncDecConfig, MoEConfig,
                                ShapeSpec, runnable)

ARCHS = {m.CONFIG.name: m.CONFIG for m in [
    internvl2_76b, phi4_mini_3_8b, deepseek_7b, starcoder2_3b, olmo_1b,
    granite_moe_3b, mixtral_8x22b, seamless_m4t_large, xlstm_125m, hymba_1_5b,
]}

ZOO = paper_zoo.ZOO


def get_config(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in ZOO:
        return ZOO[name]
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(ARCHS) + sorted(ZOO)}")


__all__ = ["ArchConfig", "MoEConfig", "EncDecConfig", "ShapeSpec", "SHAPES",
           "runnable", "ARCHS", "ZOO", "get_config"]
