"""Config registry: ``--arch <id>`` resolves here."""

from repro_torch.configs.base import SHAPES, MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401

_MODULES = {
    "granite-20b": "granite_20b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen2.5-14b": "qwen2_5_14b",
    "stablelm-12b": "stablelm_12b",
    "whisper-base": "whisper_base",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
