"""Numerics policy: how the paper's approximate multiplier enters the
model's matmuls (``AMRNumerics`` + ``approx_matmul``), the mode registry,
site- and layer-resolved policies with their JSON files, the ambient
scope they resolve against (with its audit channel), and the int8
quantizer it all rests on."""
from .approx_matmul import AMRNumerics, approx_matmul
from .context import AuditTrace, NumericsScope, current_scope, numerics_scope
from .policy import (NumericsPolicy, PerLayerPolicy, UniformPolicy, as_policy, load_policy,
                     numerics_from_json, numerics_to_json, policy_from_json, policy_summary,
                     policy_to_json, resolve_numerics, save_policy)
from .quant import dequantize, quantize_int8
from .registry import (ModeSpec, default_policy, get_mode, is_exact_mode, mode_names,
                       register_mode, validate_policy)

__all__ = ["AMRNumerics", "approx_matmul", "mode_names", "quantize_int8", "dequantize",
           "ModeSpec", "register_mode", "get_mode", "is_exact_mode", "validate_policy",
           "default_policy", "AuditTrace", "NumericsScope", "numerics_scope", "current_scope",
           "NumericsPolicy", "UniformPolicy", "PerLayerPolicy", "as_policy", "resolve_numerics",
           "numerics_to_json", "numerics_from_json", "policy_to_json", "policy_from_json",
           "save_policy", "load_policy", "policy_summary"]
