"""Carry Llama weights from the JAX package's `state_dict` naming.

≙ the structured names of `paddle_tpu/nn/layer/layers.py` `state_dict`:
``model.embed_tokens.weight``, ``model.layers.{i}.input_layernorm.weight``,
``model.layers.{i}.post_attention_layernorm.weight``,
``model.layers.{i}.self_attn.{q,k,v,o}_proj.weight``,
``model.layers.{i}.mlp.{gate,up,down}_proj.weight``, ``model.norm.weight``
and ``lm_head.weight`` (absent when the embeddings are tied). The port's
module tree uses the same names, so the carry is a name check plus a
transpose of every Linear weight: the JAX package stores (in, out),
torch (out, in). The rope tables are non-persistent buffers on both
sides and are recomputed, not carried. `quantized_weight_from_numpy`
carries one quantized weight the same way. `llama_numpy_from_tensors`
goes the other way, for parameters or their gradients: the JAX names,
the (in, out) layout, f32 numpy arrays.

The MoE and BERT models carry the same way against a built model's own
state dict (`moe_state_from_numpy`, `bert_state_from_numpy`; back with
the ``*_grads_to_numpy`` / ``*_state_to_numpy`` helpers): their Linear
weights transpose, and everything else — embeddings, norms, biases, the
MoE router (H, E) and the stacked experts (E, H, I) / (E, I, H), which
keep the JAX layout — crosses unchanged.

GPT, ERNIE and DiT carry the same way (``gpt_``, ``ernie_`` and
``dit_state_from_numpy`` and their ``_to_numpy`` / grads helpers): each
Linear weight transposes; a tied weight (GPT's ``wte``, ERNIE's word
embedding) is one entry, as in the JAX state dict; DiT's ``pos_embed`` is
a non-persistent buffer on both sides and is not carried.

The incubate `Fused*` layers keep the JAX layouts of every parameter
((in, out) weights, the fused (3, H, head_dim, E) QKV weight), so
`fused_layer_state_from_numpy` and its ``_to_numpy`` / grads helpers
carry them under the same names with no transpose, checking names and
shapes.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LAYER_KEYS = ("input_layernorm.weight", "post_attention_layernorm.weight",
               "self_attn.q_proj.weight", "self_attn.k_proj.weight",
               "self_attn.v_proj.weight", "self_attn.o_proj.weight",
               "mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight")
_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)")


def _expected_names(sd) -> set:
    n_layers = 1 + max((int(m.group(1)) for k in sd
                        if (m := _LAYER_RE.fullmatch(k))), default=-1)
    names = {"model.embed_tokens.weight", "model.norm.weight"}
    if "lm_head.weight" in sd:
        names.add("lm_head.weight")
    names |= {f"model.layers.{i}.{k}" for i in range(n_layers)
              for k in _LAYER_KEYS}
    return names


def llama_state_from_numpy(sd: Dict[str, np.ndarray],
                           model: torch.nn.Module | None = None
                           ) -> Dict[str, torch.Tensor]:
    """Map a JAX Llama ``{name: numpy array}`` state dict onto the
    port's parameter names, transposing the Linear weights.

    Raises ValueError on an unexpected key, on a missing key (every
    layer up to the highest index present must be complete), on a
    weight whose width disagrees with the embedding's hidden size, and,
    when ``model`` is given, on any key or shape that differs from the
    model's own state dict. The tensors stay on the CPU in the arrays'
    dtype; ``model.load_state_dict`` copies them to the model's device
    and dtype."""
    want = _expected_names(sd)
    if model is not None:
        want = set(model.state_dict())
    missing = sorted(want - set(sd))
    unexpected = sorted(set(sd) - want)
    if missing or unexpected:
        raise ValueError(f"state dict mismatch: missing {missing}, "
                         f"unexpected {unexpected}")
    out = {}
    for name, arr in sd.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            t = t.T.contiguous()
        out[name] = t
    hidden = out["model.embed_tokens.weight"].shape[1]
    bad = []
    for name, t in out.items():
        if name.endswith("norm.weight"):
            ok = tuple(t.shape) == (hidden,)
        elif name.endswith(("o_proj.weight", "down_proj.weight")):
            ok = t.ndim == 2 and t.shape[0] == hidden
        else:
            ok = t.ndim == 2 and t.shape[1] == hidden
        if not ok:
            bad.append(f"{name}: {tuple(t.shape)} (hidden {hidden})")
    if model is not None:
        ref = model.state_dict()
        bad += [f"{k}: {tuple(t.shape)} vs model {tuple(ref[k].shape)}"
                for k, t in out.items() if t.shape != ref[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    return out


def quantized_weight_from_numpy(qw: np.ndarray, scale: np.ndarray):
    """Carry a JAX `QuantizedWeight` (``qw`` (K, N) int8 or
    float8_e4m3fn storage as a numpy array, ``scale`` (N,) f32 per
    output channel) into the port's `ops.quant_matmul.QuantizedWeight`:
    ``qw`` transposed to (N, K), the bytes unchanged, ``scale``
    unchanged. numpy has no fp8 dtype of its own (JAX's arrays carry
    ml_dtypes' ``float8_e4m3fn``), so fp8 crosses as its bytes."""
    from ..ops.quant_matmul import QuantizedWeight
    qw = np.asarray(qw)
    if qw.ndim != 2 or np.shape(scale) != (qw.shape[1],):
        raise ValueError(f"want qw (K, N) and scale (N,), got "
                         f"{qw.shape} and {np.shape(scale)}")
    if qw.dtype == np.int8:
        t = torch.from_numpy(np.ascontiguousarray(qw.T))
    elif qw.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.ascontiguousarray(qw.T).view(np.uint8)) \
            .view(torch.float8_e4m3fn)
    else:
        raise ValueError(f"quantized storage must be int8 or "
                         f"float8_e4m3fn, got {qw.dtype}")
    return QuantizedWeight(t, torch.from_numpy(
        np.array(scale, np.float32, copy=True)))


def _jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    if name.endswith("_proj.weight") or name == "lm_head.weight":
        a = np.ascontiguousarray(a.T)
    return a


def llama_numpy_from_tensors(tensors: Dict[str, torch.Tensor]
                             ) -> Dict[str, np.ndarray]:
    """The inverse of `llama_state_from_numpy`: ``{port parameter name:
    tensor}`` (the parameters, or their gradients) to ``{JAX name: f32
    numpy array}`` in the JAX package's layout, every Linear weight
    transposed back to (in, out). Raises ValueError on a name the JAX
    Llama does not have."""
    bad = sorted(set(tensors) - _expected_names(tensors))
    if bad:
        raise ValueError(f"not Llama parameter names: {bad}")
    return {name: _jax_layout(name, t) for name, t in tensors.items()}


def llama_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter's ``.grad`` of a port Llama, as
    `llama_numpy_from_tensors` lays them out (a parameter without a
    gradient is left out)."""
    return llama_numpy_from_tensors({n: p.grad for n, p in
                                     model.named_parameters()
                                     if p.grad is not None})


def llama_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A port Llama's parameters, as `llama_numpy_from_tensors` lays them
    out."""
    return llama_numpy_from_tensors(dict(model.named_parameters()))


# ---------------------------------------------------------------------------
# MoE and BERT: carried against the model's own state dict
# ---------------------------------------------------------------------------
_MOE_LINEAR = re.compile(r".*(_proj|shared_(gate|up|down))\.weight|"
                         r"lm_head\.weight")
_NO_LINEAR = re.compile(r"(?!)")   # matches no name
_BERT_LINEAR = re.compile(r".*\.(q_proj|k_proj|v_proj|out_proj|linear1|"
                          r"linear2|pooler|transform)\.weight")
_GPT_LINEAR = re.compile(r".*\.(qkv|proj|fc)\.weight|lm_head\.weight")
_ERNIE_LINEAR = re.compile(r"(.*\.)?(q_proj|k_proj|v_proj|out_proj|linear1|"
                           r"linear2|pooler|transform|seq_relationship|"
                           r"classifier)\.weight")
# every DiT weight but the label table is a Linear's (its norms have none)
_DIT_LINEAR = re.compile(r"(?!y_embedder\.).*\.weight")


def _state_from_numpy(sd, model, linear_re):
    ref = model.state_dict()
    missing = sorted(set(ref) - set(sd))
    unexpected = sorted(set(sd) - set(ref))
    if missing or unexpected:
        raise ValueError(f"state dict mismatch: missing {missing}, "
                         f"unexpected {unexpected}")
    out = {}
    for name, arr in sd.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        if linear_re.fullmatch(name):
            t = t.T.contiguous()
        out[name] = t
    bad = [f"{k}: {tuple(t.shape)} vs model {tuple(ref[k].shape)}"
           for k, t in out.items() if t.shape != ref[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    return out


def _numpy_from_tensors(tensors, model, linear_re):
    """{parameter name: tensor} (the parameters or their gradients) to
    f32 numpy arrays in the JAX layout, Linear weights transposed back."""
    bad = sorted(set(tensors) - set(model.state_dict()))
    if bad:
        raise ValueError(f"not parameter names of the model: {bad}")
    out = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        out[name] = np.ascontiguousarray(a.T) if linear_re.fullmatch(name) \
            else a
    return out


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def moe_state_from_numpy(sd: Dict[str, np.ndarray], model: torch.nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """Map a JAX `MoEForCausalLM` ``{name: numpy array}`` state dict onto
    ``model``'s parameters (the names are the same), transposing the
    Linear weights (attention projections, shared experts, lm_head).
    Raises ValueError on a missing or unexpected key or a shape that
    differs from the model's."""
    return _state_from_numpy(sd, model, _MOE_LINEAR)


def moe_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter's ``.grad`` as JAX-layout f32 numpy arrays (a
    parameter without a gradient is left out)."""
    return _numpy_from_tensors(_grads(model), model, _MOE_LINEAR)


def moe_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _MOE_LINEAR)


def bert_state_from_numpy(sd: Dict[str, np.ndarray], model: torch.nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """Map a JAX `BertForMaskedLM` state dict onto ``model``'s
    parameters (the same names; the LM head's decoder is the word
    embedding, one entry), transposing the Linear weights. Raises as
    `moe_state_from_numpy`."""
    return _state_from_numpy(sd, model, _BERT_LINEAR)


def bert_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(_grads(model), model, _BERT_LINEAR)


def bert_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _BERT_LINEAR)


def gpt_state_from_numpy(sd: Dict[str, np.ndarray], model: torch.nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """Map a JAX `GPTForCausalLM` state dict onto ``model``'s parameters
    (the same ``transformer.*`` names; the tied head is ``wte``, one
    entry), transposing the Linear weights. Raises as
    `moe_state_from_numpy`."""
    return _state_from_numpy(sd, model, _GPT_LINEAR)


def gpt_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(_grads(model), model, _GPT_LINEAR)


def gpt_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _GPT_LINEAR)


def ernie_state_from_numpy(sd: Dict[str, np.ndarray],
                           model: torch.nn.Module
                           ) -> Dict[str, torch.Tensor]:
    """Map a JAX `ErnieForPretraining` or
    `ErnieForSequenceClassification` state dict onto ``model``'s
    parameters (the same names; the MLM decoder is the word embedding,
    one entry), transposing the Linear weights. Raises as
    `moe_state_from_numpy`."""
    return _state_from_numpy(sd, model, _ERNIE_LINEAR)


def ernie_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(_grads(model), model, _ERNIE_LINEAR)


def ernie_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _ERNIE_LINEAR)


def dit_state_from_numpy(sd: Dict[str, np.ndarray], model: torch.nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """Map a JAX `DiT` state dict onto ``model``'s parameters (the same
    names: ``t_embedder.mlp.0`` / ``.2`` are the Sequential's Linears),
    transposing every Linear weight. Raises as `moe_state_from_numpy`."""
    return _state_from_numpy(sd, model, _DIT_LINEAR)


def dit_grads_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(_grads(model), model, _DIT_LINEAR)


def dit_state_to_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _DIT_LINEAR)


def fused_layer_state_from_numpy(sd: Dict[str, np.ndarray],
                                 model: torch.nn.Module
                                 ) -> Dict[str, torch.Tensor]:
    """Map a JAX `Fused*` layer's state dict onto ``model``'s parameters:
    the same names and layouts, nothing transposed. Raises as
    `moe_state_from_numpy`."""
    return _state_from_numpy(sd, model, _NO_LINEAR)


def fused_layer_grads_to_numpy(model: torch.nn.Module
                               ) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(_grads(model), model, _NO_LINEAR)


def fused_layer_state_to_numpy(model: torch.nn.Module
                               ) -> Dict[str, np.ndarray]:
    return _numpy_from_tensors(dict(model.named_parameters()), model,
                               _NO_LINEAR)
