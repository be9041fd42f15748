"""Parameters of the reference package in the port's layout: the LM
families (:func:`from_reference_params`) and the paper's two edge DNNs,
BraggNN and CookieNetAE (:func:`paper_model_from_reference_params`).

jax and torch generators give different numbers from the same seed, so
the tests that compare the two packages make parameters with the
reference's ``init``, turn its pytree into nested dicts of numpy float32
arrays, and convert them here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import keeps_float32


def from_reference_params(tree: Dict[str, Any], *, device="cuda",
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, Any]:
    """Convert the reference's parameter pytree (nested dicts of numpy
    arrays) into tensors on ``device``.  Weights and biases take ``dtype``
    (the compute dtype, or float32 for training masters); norm parameters
    and the recurrent families' gate and decay parameters
    (``common.keeps_float32``) stay float32, as the port's own inits keep
    them; the MoE router takes ``dtype`` like any weight.  The reference's
    layouts are kept: the transformer's stacked ``blocks`` (leading layer
    axis; the MoE layer's ``router`` and ``experts_w_*`` stacks and
    ``shared`` MLP among them) and the MoE family's unstacked
    ``head_blocks`` list, the VLM's ``projector`` and ``lm`` (a
    transformer tree), zamba2's ``segments`` (n_seg, per, ...) and
    xLSTM's ``mlstm`` (n_seg, n_mlstm, ...) and ``slstm`` (n_seg, ...),
    and the encoder-decoder's ``embed``, ``dec_pos`` and ``frame_proj``
    (weights, in ``dtype``), ``enc_final_norm``/``dec_final_norm`` and
    the stacked ``enc_blocks``/``dec_blocks`` (their ``*_norm`` keys
    float32)."""
    dev = resolve_device(device)

    def conv(node, is_norm: bool):
        if isinstance(node, dict):
            return {k: conv(v, is_norm or keeps_float32(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v, is_norm) for v in node]
        arr = np.asarray(node)
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=dev, dtype=torch.float32 if is_norm else dtype)

    return conv(tree, False)


def paper_model_from_reference_params(tree: Dict[str, Any], *,
                                      device="cuda",
                                      dtype: torch.dtype = torch.float32
                                      ) -> Dict[str, torch.Tensor]:
    """Convert the reference's parameters of a paper model, BraggNN or
    CookieNetAE (a flat dict of numpy arrays), into the port's: conv
    weights (every 4-D array: BraggNN's non-local 1x1 convs and
    CookieNetAE's 1x1 head included) go from the reference's HWIO to
    OIHW; biases and BraggNN's (in, out) FC weights keep their layout."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.array(v))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t.to(device=dev, dtype=dtype)
    return out
