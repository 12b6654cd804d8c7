"""Batched serving engine with parked KV pages and header-only routing
(port of ``repro.serving.engine``).

KV pages are *parked* in the pool; what moves per request per step is a
``RequestHeader`` — request id, last token, position, page tags (id,
generation).  This is the single-shard engine: admission (prefill through
the decode path), decode steps against the paged pool, completion and
cancel (release = Merge / Explicit Drop), and the eviction pathology (a
prematurely evicted page fails its generation check and the request is
dropped and counted, the paper's §6.2.4 semantics).

The slot bookkeeping is host numpy, as in the reference.  The KV pools
are ``(L, num_pages, page_tokens, K, E)`` bf16 tensors on the parameters'
device, written in place.  Attention runs through the ``paged_attention``
primitive — the design the reference documents for its decode path (its
own engine gathers the pages and runs a dense softmax over the history
concatenated with the fresh token): the fresh token's k/v are written into
their page first and the primitive attends over ``pos + 1`` tokens, which
equals the reference's concatenation up to float rounding.  On the card
that is the CUDA kernel on every layer of every token; ``backend="ref"``
runs the plain version instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.backend import dispatch
from repro_torch.configs.base import ModelConfig
from repro_torch.core import counters as C
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.lm import LM, segments_for
from repro_torch.serving import pool as pool_mod
from repro_torch.serving.pool import PoolConfig

HEADER_BYTES_PER_PAGE = 8   # (page_id u32-ish, generation u16, crc u16)
HEADER_FIXED_BYTES = 16     # request id, last token, position, flags


@dataclasses.dataclass
class RequestHeader:
    """What actually crosses the pod/data axes per request per step."""
    rid: int
    token: int
    position: int
    pages: np.ndarray   # (MP,) int32, -1 padded
    gens: np.ndarray    # (MP,) int32

    def wire_bytes(self) -> int:
        live = int((self.pages >= 0).sum())
        return HEADER_FIXED_BYTES + HEADER_BYTES_PER_PAGE * live


def parked_payload_bytes(cfg: ModelConfig, position: int) -> int:
    """Bytes that would cross the wire per request per hop WITHOUT parking
    (the whole KV state) — the serving analogue of the paper's payload."""
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nheads = d_in // s.head_dim
        return cfg.num_layers * nheads * s.d_state * s.head_dim * 4
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        return cfg.num_layers * position * per_tok * 2
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
    return cfg.num_layers * position * per_tok * 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_pages_per_req: int = 16
    pool: PoolConfig = dataclasses.field(
        default_factory=lambda: PoolConfig(num_pages=128, page_tokens=16))


class ServeEngine:
    """Single-shard engine (dense, MoE and VLM GQA archs) on the
    parameters' device; an MoE layer runs ``moe_apply`` on the token.

    ``backend`` resolves the ``paged_attention`` primitive (None = auto:
    the CUDA kernel for tensors on the card, the plain version on the
    CPU); it is the counterpart of the reference kernel's ``interpret``
    switch."""

    def __init__(self, lm: LM, params, ecfg: EngineConfig, backend=None):
        cfg = lm.cfg
        if cfg.family not in ("dense", "moe", "vlm") or cfg.mla is not None:
            raise ValueError("the engine supports paged GQA archs "
                             f"(dense, moe, vlm), not {cfg.name}")
        (self.seg,) = segments_for(cfg)
        self.lm = lm
        self.params = params
        self.ecfg = ecfg
        self.attend = dispatch("paged_attention", backend)
        self.device = params["final_norm"].device
        self.pool = pool_mod.init_pool(ecfg.pool, self.device)
        p = ecfg.pool
        kv_shape = (self.seg.count, p.num_pages, p.page_tokens,
                    cfg.num_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(kv_shape, dtype=cm.DTYPE,
                                   device=self.device)
        self.v_pages = torch.zeros(kv_shape, dtype=cm.DTYPE,
                                   device=self.device)
        # request slots
        mb, mp = ecfg.max_batch, ecfg.max_pages_per_req
        self.active = np.zeros((mb,), bool)
        self.rid = np.full((mb,), -1, np.int64)
        self.pos = np.zeros((mb,), np.int32)
        self.last_tok = np.zeros((mb,), np.int32)
        self.pages = np.full((mb, mp), -1, np.int32)
        self.gens = np.zeros((mb, mp), np.int32)
        self.dropped: list[int] = []
        self.finished: dict[int, list[int]] = {}
        self.header_bytes_total = 0
        self.payload_bytes_avoided = 0

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # -- page bookkeeping ----------------------------------------------------
    def _ensure_page(self, slot: int) -> bool:
        """Allocate the page for self.pos[slot] if not yet present."""
        p = self.ecfg.pool
        need_idx = self.pos[slot] // p.page_tokens
        if need_idx >= self.ecfg.max_pages_per_req:
            return False
        if self.pages[slot, need_idx] >= 0:
            return True
        want = torch.ones((1,), dtype=torch.bool, device=self.device)
        self.pool, pg, gen, ok = pool_mod.alloc(p, self.pool, want)
        if not bool(ok[0]):
            return False
        self.pages[slot, need_idx] = int(pg[0])
        self.gens[slot, need_idx] = int(gen[0])
        return True

    def _kv_slot(self, slot: int) -> tuple[int, int]:
        """(page id, offset in the page) of the current position."""
        p = self.ecfg.pool
        pos = int(self.pos[slot])
        page = int(self.pages[slot, pos // p.page_tokens])
        if page < 0:
            raise RuntimeError(f"slot {slot}: no page for position {pos}; "
                               "_ensure_page allocates it first")
        return page, pos % p.page_tokens

    def _write_kv(self, slot: int, k_new, v_new) -> None:
        """k_new/v_new: (L, K, E) for the current position."""
        page, off = self._kv_slot(slot)
        self.k_pages[:, page, off] = k_new
        self.v_pages[:, page, off] = v_new

    # -- admission -------------------------------------------------------------
    def admit(self, rid: int, prompt: list[int]) -> bool:
        free = np.where(~self.active)[0]
        if len(free) == 0:
            return False
        slot = int(free[0])
        self.active[slot] = True
        self.rid[slot] = rid
        self.pos[slot] = 0
        self.pages[slot] = -1
        self.gens[slot] = 0
        self.finished[rid] = list(prompt)
        # sequential prefill through the decode path; only the final prompt
        # token's logits produce a generated token
        for i, tok in enumerate(prompt):
            if not self._step_one(slot, tok, record=(i == len(prompt) - 1)):
                return False
        return True

    # -- decode -------------------------------------------------------------------
    def _step_one(self, slot: int, token: int, record: bool = True) -> bool:
        """Advance one request by one token.  Returns False on drop."""
        cfg = self.lm.cfg
        if not self._ensure_page(slot):
            self._drop(slot)
            return False
        # validate every page generation (Merge stage-2 check)
        okv = pool_mod.validate(self.pool, self._tensor(self.pages[slot]),
                                self._tensor(self.gens[slot]))
        if not bool(okv):
            self._drop(slot)
            return False
        logits, k_new, v_new = self._forward_token(slot, token)
        self._write_kv(slot, k_new, v_new)
        self.last_tok[slot] = int(torch.argmax(logits))
        if record:
            self.finished[int(self.rid[slot])].append(
                int(self.last_tok[slot]))
        self.pos[slot] += 1
        # header-only routing accounting
        hdr = RequestHeader(int(self.rid[slot]), token, int(self.pos[slot]),
                            self.pages[slot], self.gens[slot])
        self.header_bytes_total += hdr.wire_bytes()
        self.payload_bytes_avoided += parked_payload_bytes(
            cfg, int(self.pos[slot]))
        return True

    def _forward_token(self, slot: int, token: int):
        """Run the decoder stack for one token of one request, attending
        over the paged pool.  The fresh k/v of each layer are written into
        the token's page (allocated by ``_ensure_page``) before that layer's
        attention.  Returns (logits, k_new (L,K,E), v_new)."""
        cfg = self.lm.cfg
        lmp = self.params
        pos = int(self.pos[slot])
        page, off = self._kv_slot(slot)
        x = cm.embed_apply(lmp["embed"], self._tensor([[token]], torch.int64),
                           cfg)
        cos, sin = cm.rope_angles(self._tensor([[pos]]), cfg.head_dim,
                                  cfg.rope_theta)
        pt = self._tensor(self.pages[slot][None])        # (1, MP)
        lengths = self._tensor([pos + 1])                # history + fresh
        k_out, v_out = [], []
        seg_params = lmp[self.seg.name]["sub0"]
        for li in range(self.seg.count):
            pl_ = _layer(seg_params, li)
            h = cm.rmsnorm(x, pl_["ln1"], cfg.norm_eps)
            q, k, v = cm.attn_qkv(pl_["attn"], h, cfg, cos, sin)
            k_out.append(k[0, 0])
            v_out.append(v[0, 0])
            self.k_pages[li, page, off] = k[0, 0]
            self.v_pages[li, page, off] = v[0, 0]
            o = self.attend(q[:, 0], self.k_pages[li], self.v_pages[li], pt,
                            lengths)
            x = x + cm.attn_out(pl_["attn"], o[:, None])
            h2 = cm.rmsnorm(x, pl_["ln2"], cfg.norm_eps)
            if "router" in pl_["ffn"]:
                x = x + moe_mod.moe_apply(pl_["ffn"], h2, cfg, cfg.act)[0]
            else:
                x = x + cm.mlp_apply(pl_["ffn"], h2, cfg.act)
        x = cm.rmsnorm(x, lmp["final_norm"], cfg.norm_eps)
        logits = cm.unembed_apply(lmp["embed"], x, cfg)[0, 0]
        return logits, torch.stack(k_out), torch.stack(v_out)

    def step(self) -> None:
        """One decode step for every active request."""
        for slot in np.where(self.active)[0]:
            self._step_one(int(slot), int(self.last_tok[slot]))

    # -- completion ------------------------------------------------------------
    def finish(self, rid: int, cancel: bool = False) -> Optional[list[int]]:
        """Merge (normal completion) or Explicit Drop (cancel)."""
        slots = np.where(self.active & (self.rid == rid))[0]
        if len(slots) == 0:
            return None
        slot = int(slots[0])
        self._release(slot, explicit=cancel)
        return self.finished.pop(int(self.rid[slot]), None)

    def _drop(self, slot: int) -> None:
        """A failed allocation or generation check: release what the
        request still holds (stale pages are counted as premature
        evictions) and record it as dropped."""
        self.dropped.append(int(self.rid[slot]))
        self._release(slot, explicit=True)

    def _release(self, slot: int, explicit: bool) -> None:
        self.pool = pool_mod.release(
            self.ecfg.pool, self.pool, self._tensor(self.pages[slot]),
            self._tensor(self.gens[slot]), explicit=explicit)
        self.active[slot] = False

    # -- stats --------------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        d = C.as_dict(self.pool.counters)
        d["occupancy"] = int(pool_mod.occupancy(self.pool))
        d["header_bytes"] = self.header_bytes_total
        d["payload_bytes_avoided"] = self.payload_bytes_avoided
        d["goodput_gain"] = (
            self.payload_bytes_avoided
            / max(self.header_bytes_total, 1))
        return d


def _layer(stacked: dict, li: int) -> dict:
    """Layer ``li`` of a dict of stacked (L, ...) parameters (views)."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in stacked.items()}
