"""HuggingFace GPT-2 checkpoint interop.  Counterpart of
``ray_tpu/models/hf.py``.

``from_hf_gpt2`` maps a GPT-2 checkpoint's weights into the port's GPT
param tree (``models/gpt.py``: layers stacked on a leading axis), so a
GPT-2 checkpoint trains, decodes and serves on the port's path:

  * HF's Conv1D stores a weight as [in_features, out_features], the
    orientation the port's matmuls take: no transposes;
  * ``c_attn`` packs q, k and v along its output axis: thirds;
  * GPT-2's activation is the tanh GELU and its layer norm's epsilon
    1e-5, which ``ops/layers.py`` computes;
  * ``lm_head`` is tied to ``wte`` (``tie_embeddings=True``), and the
    projections have biases (``attn_bias=True``).

It takes a ``transformers`` model object, or a state dict (name ->
tensor or array) with the HF config's fields as a mapping or an object.
It takes no model name: a name would download weights (ROADMAP §C).
``transformers`` is never imported here.  Variants whose math differs
from what the converter assumes raise, as the reference's do.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

from . import gpt

__all__ = ["from_hf_gpt2"]


def _field(hc: Any, name: str, default: Any = None) -> Any:
    if isinstance(hc, Mapping):
        return hc.get(name, default)
    return getattr(hc, name, default)


def _check_supported(hc: Any) -> None:
    """Refuse variants that change the math the converter assumes."""
    act = _field(hc, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"activation_function={act!r} (converter assumes the tanh "
            f"GELU GPT-2 ships with)")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if _field(hc, flag, False):
            raise NotImplementedError(f"{flag}=True is not supported")
    ln_eps = float(_field(hc, "layer_norm_epsilon", 1e-5))
    if abs(ln_eps - 1e-5) > 1e-12:
        raise NotImplementedError(
            f"layer_norm_epsilon={ln_eps!r} (converter assumes GPT-2's "
            f"default 1e-5, which is what the port's layer_norm uses)")


def _numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def from_hf_gpt2(model: Any, *, config: Optional[Any] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, **cfg_overrides
                 ) -> Tuple[gpt.GPTConfig, Dict[str, Any]]:
    """A GPT-2 checkpoint -> (cfg, params) on ``device``.

    ``model`` is a ``transformers`` GPT2LMHeadModel (or GPT2Model), or a
    state dict with or without the ``transformer.`` prefix; ``config``
    holds the HF config's fields (``n_embd``, ``n_head``, ``n_layer``,
    ``vocab_size``, ``n_positions``, optional ``n_inner`` and the
    variant flags) and defaults to the model's own ``config``."""
    if isinstance(model, (str, bytes)):
        raise TypeError(
            "from_hf_gpt2 takes a model object or a state dict; a model "
            "name would download its weights")
    if isinstance(model, Mapping):
        sd, hc = model, config
        if hc is None:
            raise ValueError("a state dict needs config= (the HF config's "
                             "fields)")
    else:
        sd, hc = model.state_dict(), (config if config is not None
                                      else model.config)
    _check_supported(hc)
    dev = resolve_device(device)
    prefix = "transformer." if any(k.startswith("transformer.")
                                   for k in sd) else ""

    D, H, L = (int(_field(hc, "n_embd")), int(_field(hc, "n_head")),
               int(_field(hc, "n_layer")))
    dh = D // H
    F = _field(hc, "n_inner") or 4 * D
    cfg = gpt.GPTConfig(
        n_layers=L, d_model=D, n_heads=H, d_head=dh, d_ff=int(F),
        vocab_size=int(_field(hc, "vocab_size")),
        max_seq=int(_field(hc, "n_positions")), norm="ln", act="gelu",
        pos="learned", tie_embeddings=True, attn_bias=True, dtype=dtype,
        param_dtype=param_dtype, **cfg_overrides)

    def g(name):
        return _numpy(sd[prefix + name])

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=param_dtype)

    def stack(fmt, shape=None):
        arrs = [g(fmt.format(i)) for i in range(L)]
        if shape is not None:
            arrs = [a.reshape(shape) for a in arrs]
        return put(np.stack(arrs))

    # one pass over c_attn per layer: q, k, v are its output thirds
    qkv_w, qkv_b = [[], [], []], [[], [], []]
    for i in range(L):
        w = g(f"h.{i}.attn.c_attn.weight")            # [D, 3D]
        b = g(f"h.{i}.attn.c_attn.bias")              # [3D]
        for j in range(3):
            qkv_w[j].append(w[:, j * D:(j + 1) * D].reshape(D, H, dh))
            qkv_b[j].append(b[j * D:(j + 1) * D].reshape(H, dh))
    (wq, wk, wv), (wq_b, wk_b, wv_b) = (
        [put(np.stack(a)) for a in qkv_w], [put(np.stack(a)) for a in qkv_b])
    lp = {
        "attn_norm": stack("h.{}.ln_1.weight"),
        "attn_norm_b": stack("h.{}.ln_1.bias"),
        "wq": wq, "wk": wk, "wv": wv,
        "wq_b": wq_b, "wk_b": wk_b, "wv_b": wv_b,
        "wo": stack("h.{}.attn.c_proj.weight", (H, dh, D)),
        "wo_b": stack("h.{}.attn.c_proj.bias"),
        "mlp_norm": stack("h.{}.ln_2.weight"),
        "mlp_norm_b": stack("h.{}.ln_2.bias"),
        "mlp_in": stack("h.{}.mlp.c_fc.weight"),
        "mlp_in_b": stack("h.{}.mlp.c_fc.bias"),
        "mlp_out": stack("h.{}.mlp.c_proj.weight"),
        "mlp_out_b": stack("h.{}.mlp.c_proj.bias"),
    }
    params = {"embed": put(g("wte.weight")), "pos_embed": put(g("wpe.weight")),
              "layers": lp, "final_norm": put(g("ln_f.weight")),
              "final_norm_b": put(g("ln_f.bias"))}
    return cfg, params
