"""Shape-only stand-ins for every model input (port of
``repro.launch.inputs``): tensors on ``device="meta"``, which carry shape
and dtype and allocate nothing (the reference's ``ShapeDtypeStruct``s).

``input_specs(lm, shape)`` returns the argument tuple for the step
function a given (arch x shape) cell runs:
  train_*   -> (train_state, batch)        for train_step
  prefill_* -> (params, batch)             for prefill
  decode_*/long_* -> (params, cache, tokens, positions) for decode_step

Modality frontends are stubs: the vlm cell's batch carries precomputed
patch embeddings (B, NV, D); the audio cell's batch carries precomputed
frames (B, S, D).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.common import DTYPE
from repro_torch.models.lm import LM

VLM_PATCH_TOKENS = 256


def sds(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s)), "labels": sds((b, s))}
    if cfg.family == "vlm":
        batch["positions"] = sds((3, b, s))
        batch["vision_embeds"] = sds((b, VLM_PATCH_TOKENS, cfg.d_model),
                                     DTYPE)
    if cfg.enc_layers:
        batch["enc_frames"] = sds((b, s, cfg.d_model), DTYPE)
    return batch


def prefill_batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = train_batch_struct(cfg, shape)
    del batch["labels"]
    return batch


def train_state_struct(lm: LM) -> dict:
    from repro_torch.training.train_step import init_train_state
    return init_train_state(lm, device="meta")


def params_struct(lm: LM) -> dict:
    return lm.init_params(device="meta")


def decode_inputs_struct(lm: LM, shape: ShapeConfig):
    cfg = lm.cfg
    b, s = shape.global_batch, shape.seq_len
    cache = lm.init_cache(b, s, enc_len=s if cfg.enc_layers else 0,
                          device="meta")
    return params_struct(lm), cache, sds((b,)), sds((b,))


def input_specs(lm: LM, shape: ShapeConfig):
    """The shape-only argument tuple for the cell's step function."""
    cfg = lm.cfg
    if shape.kind == "train":
        return (train_state_struct(lm), train_batch_struct(cfg, shape))
    if shape.kind == "prefill":
        return (params_struct(lm), prefill_batch_struct(cfg, shape))
    return decode_inputs_struct(lm, shape)
