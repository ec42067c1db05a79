"""LM-family model zoo of the port (PyTorch, a loop over stacked
superblocks): dense, MoE, SSM, hybrid, encoder-decoder and VLM, for
serving and for training (``loss_fn``)."""
from .model import (
    ModelRuntime, active_param_count, decode_step, encode, forward_train,
    init_cache, init_params, loss_fn, param_count, param_defs, param_pspecs,
    params_from_numpy, prefill,
)
from .sharding import (
    MEGATRON_RULES, REPLICATED_RULES, Rules, ShardingPlan,
)

__all__ = [
    "ModelRuntime", "decode_step", "encode", "forward_train", "init_cache",
    "init_params", "loss_fn", "param_count", "active_param_count", "param_defs",
    "param_pspecs", "params_from_numpy", "prefill",
    "Rules", "ShardingPlan", "MEGATRON_RULES", "REPLICATED_RULES",
]
