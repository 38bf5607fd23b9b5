"""Host-tier expert parameter store (port of ``repro.core.expert_store``).

Experts live here, in host memory, as torch tensors — fp32, or int8
with one fp32 scale per column under ``quant="int8"`` — PINNED when the
store feeds a CUDA device, so a cache install is a real asynchronous
host->device DMA of the stored bytes (``payload``; the cache
dequantizes int8 on the device). The int8 per-channel quantization and
the CRC32 payload checksums are the JAX package's, computed with the
same numpy code, so stored bytes, byte counts and checksums agree.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Key = Tuple[int, int]  # (layer, expert_id)


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(v, dtype=np.float32)


def payload_checksum(weights: dict) -> int:
    """crc32 over the fp32 payload bytes, matrices in name order. Fast
    enough to run per delivery under fault injection, strong enough to
    catch any single flipped byte (see ``ExpertStore.verify``)."""
    crc = 0
    for name in sorted(weights):
        crc = zlib.crc32(_host_array(weights[name]).tobytes(), crc)
    return crc


def _quantize_int8(w: np.ndarray):
    scale = np.max(np.abs(w), axis=0, keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


class ExpertStore:
    def __init__(self, *, quant: str = "none", pin: bool = False):
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        self.quant = quant
        self.pin = pin
        self._data: Dict[Key, dict] = {}
        self._checksums: Dict[Key, int] = {}  # lazy, of the fp32 payload

    def _host(self, v) -> torch.Tensor:
        """A host copy of ``v`` (tensor on any device, or array), pinned
        if the store is."""
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=self.pin)
        out.copy_(src)
        return out

    def put(self, key: Key, weights: dict) -> None:
        """weights: {'w1': [d,ff], 'w3': [d,ff], 'w2': [ff,d]} (tensors
        on any device, or arrays)."""
        if self.quant == "int8":
            entry = {}
            for k, v in weights.items():
                q, s = _quantize_int8(_host_array(v))
                entry[k] = ("int8", self._host(q), self._host(s))
            self._data[key] = entry
        else:
            self._data[key] = {
                k: ("raw", self._host(v.float() if isinstance(v, torch.Tensor)
                                      else _host_array(v)), None)
                for k, v in weights.items()}
        self._checksums.pop(key, None)

    def payload(self, key: Key) -> Dict[str, Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]]:
        """The stored payload as it is, per matrix: ``(int8 tensor, its
        [1, cols] fp32 scale row)`` under int8, ``(fp32 tensor, None)``
        otherwise; pinned if the store is. What an install copies."""
        return {k: (v, s) for k, (_, v, s) in self._data[key].items()}

    def fetch(self, key: Key) -> dict:
        """Dequantized fp32 weights (host tensors; the stored ones
        themselves when unquantized). The checksum's payload, and what
        a corrupted delivery corrupts."""
        out = {}
        for k, (kind, v, s) in self._data[key].items():
            out[k] = v.float() * s if kind == "int8" else v
        return out

    def checksum(self, key: Key) -> int:
        """Reference checksum of ``key``'s dequantized payload (lazily
        computed on first ask, cached until ``put`` overwrites)."""
        if key not in self._checksums:
            self._checksums[key] = payload_checksum(self.fetch(key))
        return self._checksums[key]

    def verify(self, key: Key, weights: dict) -> bool:
        """True iff ``weights`` is a faithful delivery of ``key``'s
        payload (checksums match). Under fault injection every
        delivered fetch is verified; a corrupted copy fails here and
        is refetched (see ``ExpertCache._install``)."""
        return payload_checksum(weights) == self.checksum(key)

    def expert_nbytes(self, key: Key) -> int:
        n = 0
        for kind, v, s in self._data[key].values():
            n += v.nbytes + (s.nbytes if s is not None else 0)
        return n

    def total_nbytes(self) -> int:
        return sum(self.expert_nbytes(k) for k in self._data)

    def keys(self):
        return list(self._data)

    @classmethod
    def from_params(cls, params, cfg, *, quant: str = "none",
                    pin: bool = False) -> "ExpertStore":
        """Copy the per-layer expert weights of a stacked param tree
        (``params['layers']['moe']['experts']``, [L, E, ...] tensors on
        any device) into a store, one expert at a time."""
        store = cls(quant=quant, pin=pin)
        experts = params["layers"]["moe"]["experts"]
        L, E = experts["w1"].shape[:2]
        for l in range(L):
            for e in range(E):
                store.put((l, e), {"w1": experts["w1"][l, e],
                                   "w3": experts["w3"][l, e],
                                   "w2": experts["w2"][l, e]})
        return store
