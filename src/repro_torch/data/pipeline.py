"""Token data pipeline: deterministic, resumable, host-shard aware (the JAX
package's, batches as torch tensors on the pipeline's device).

Two sources:
* SyntheticLM — a fixed random bigram process with numpy's generator keyed
  by (seed, step, host_index), so the tokens equal the JAX package's bit
  for bit and a model has structure to learn.
* TextFileLM  — byte-level tokens of a local corpus file, chunked.

``state()`` returns the cursor a checkpoint stores; ``restore(cursor)``
resumes the stream exactly.  Each host draws only its shard of the global
batch (``host_index``/``host_count``).  For an audio or vision front end,
SyntheticLM's batches also carry the stub's precomputed embeddings
(``enc_inputs`` or ``img_embeds``), drawn from the same generator after the
tokens, as the JAX package draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    vocab: int = 256
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    frontend: str = "none"           # none | audio | vision
    d_model: int = 0                 # for the front-end embedding stubs
    img_seq: int = 0
    enc_len: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.host_count} hosts")
        return self.global_batch // self.host_count


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("data pipeline: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def _batch(toks: np.ndarray, device) -> Dict[str, torch.Tensor]:
    toks = torch.from_numpy(toks)
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}


def _frontend_stub(cfg: DataConfig, rng,
                   device) -> Dict[str, torch.Tensor]:
    """The front end's precomputed embeddings (the modality stub): frame
    embeddings (B, enc_len or seq_len, d_model) for audio, patch embeddings
    (B, img_seq, d_model) for vision, fp32 standard normals from ``rng``."""
    out = {}
    if cfg.frontend == "audio" and cfg.d_model:
        enc_len = cfg.enc_len or cfg.seq_len
        out["enc_inputs"] = rng.standard_normal(
            (cfg.host_batch, enc_len, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "vision" and cfg.d_model:
        out["img_embeds"] = rng.standard_normal(
            (cfg.host_batch, cfg.img_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


class SyntheticLM:
    """Markov-chain pseudo-language: tokens follow a fixed random bigram
    table (each token has 8 successors), so a model reaches a loss well
    below log(V), ~log(8)."""

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = _device(device)
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, 8)).astype(
            np.int32)
        self._step = 0

    def state(self) -> Dict:
        return {"step": self._step}

    def restore(self, state: Dict) -> None:
        self._step = int(state["step"])

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self._step, cfg.host_index))
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        choices = rng.integers(0, 8, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        self._step += 1
        batch = _batch(toks, self.device)
        batch.update(_frontend_stub(cfg, rng, self.device))
        return batch


class TextFileLM:
    """Byte-level LM over a local file, sequential chunks, resumable."""

    def __init__(self, cfg: DataConfig, path: str, *, device="cuda"):
        self.cfg = cfg
        self.device = _device(device)
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        if self.data.size <= cfg.seq_len + 1:
            raise ValueError(f"corpus {path} holds {self.data.size} bytes, "
                             f"too few for sequences of {cfg.seq_len}")
        self._cursor = 0

    def state(self) -> Dict:
        return {"cursor": self._cursor}

    def restore(self, state: Dict) -> None:
        self._cursor = int(state["cursor"])

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        n = self.data.size - (s + 1)
        rows = []
        for i in range(b):
            start = (self._cursor + i * (s + 1)) % n
            rows.append(self.data[start:start + s + 1].astype(np.int32))
        self._cursor = (self._cursor + b * (s + 1)) % n
        return _batch(np.stack(rows), self.device)


def make_pipeline(cfg: DataConfig, corpus: Optional[str] = None, *,
                  device="cuda"):
    if corpus:
        return TextFileLM(cfg, corpus, device=device)
    return SyntheticLM(cfg, device=device)
