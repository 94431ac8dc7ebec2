"""The native host runtime: a latent store whose reads run on C++ threads,
and a C++ CLIP BPE tokenizer (`csrc/comat_host.cpp`, bound by ctypes).

The port's counterpart of comat_tpu/native_host.py, under the same names:

- `NativeLatentStore` is `training.data.GanLatentStore` with its file
  reads on a pool of C++ threads that hold no GIL: `prefetch(prompts)`
  queues a batch's reads and returns at once, `gather()` waits for them.
  Which file a prompt draws stays in Python, from the same
  `random.Random(seed)` in the same order as `GanLatentStore`, so the
  two give the same latents and the trainer's checkpointed
  `latent_store.rng` means the same in both. `batch` returns what
  `GanLatentStore.batch` returns, an NCHW file transposed. Only `.npy`
  entries: an index naming any other file raises at open.
- `NativeCLIPTokenizer` has `text.tokenizer.CLIPBPETokenizer`'s
  `__call__`: the text is cleaned by the same `clean_text`, then split,
  byte-encoded and merged in C++ (its pretokenizer classes those of
  `_CLIP_PAT` under Python's `re`), so the ids equal the Python
  tokenizer's. `encode_to_tokens` delegates to a `CLIPBPETokenizer` over
  the same files, built at its first use.

The library builds with g++ at first use (`ops._build.build_host`, into
build/host/); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np

from comat_tpu_torch.ops import _build
from comat_tpu_torch.text.tokenizer import CLIPBPETokenizer, clean_text
from comat_tpu_torch.training.data import GanLatentStore, to_nhwc

_ERR_CAP = 4096
_MAX_DIMS = 32
_lib: Optional[ctypes.CDLL] = None


def load_native() -> ctypes.CDLL:
    """The host library, built if it is not (raises if the build fails)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build.build_host("comat_host"))
    c = ctypes
    err = [c.c_char_p, c.c_int]
    lib.ch_store_open.restype = c.c_void_p
    lib.ch_store_open.argtypes = [c.c_int, *err]
    lib.ch_store_prefetch.restype = None
    lib.ch_store_prefetch.argtypes = [c.c_void_p, c.POINTER(c.c_char_p), c.c_int,
                                      c.POINTER(c.c_int64)]
    lib.ch_store_fetch.restype = c.c_int
    lib.ch_store_fetch.argtypes = [c.c_void_p, c.c_int64, c.c_char_p, c.c_int,
                                   c.POINTER(c.c_int), c.POINTER(c.c_int),
                                   c.POINTER(c.c_int64), c.c_int, c.POINTER(c.c_int64), *err]
    lib.ch_store_take.restype = c.c_int
    lib.ch_store_take.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, *err]
    lib.ch_store_close.restype = None
    lib.ch_store_close.argtypes = [c.c_void_p]
    lib.ch_bpe_load.restype = c.c_void_p
    lib.ch_bpe_load.argtypes = [c.c_char_p, c.c_char_p, *err]
    lib.ch_bpe_encode_batch.restype = c.c_int
    lib.ch_bpe_encode_batch.argtypes = [c.c_void_p, c.POINTER(c.c_char_p),
                                        c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int,
                                        c.POINTER(c.c_int32), c.POINTER(c.c_int32), *err]
    for name in ("ch_bpe_bos", "ch_bpe_eos"):
        getattr(lib, name).restype = c.c_int
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.ch_pretokenize.restype = c.c_int64
    lib.ch_pretokenize.argtypes = [c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int64,
                                   *err]
    lib.ch_unicode_version.restype = c.c_char_p
    lib.ch_unicode_version.argtypes = []
    lib.ch_bpe_free.restype = None
    lib.ch_bpe_free.argtypes = [c.c_void_p]
    _lib = lib
    return lib


def _err_buf():
    return ctypes.create_string_buffer(_ERR_CAP)


def pretokenize(text: str) -> List[str]:
    """The C++ pretokenizer alone on `text` (what `_CLIP_PAT.findall`
    gives on the same text)."""
    lib = load_native()
    raw = text.encode("utf-8")
    bounds, err = (ctypes.c_int64 * (2 * len(raw) + 2))(), _err_buf()
    n = lib.ch_pretokenize(raw, len(raw), bounds, len(raw) + 1, err, _ERR_CAP)
    if n < 0:
        raise ValueError(err.value.decode())
    return [raw[bounds[2 * k]:bounds[2 * k + 1]].decode("utf-8") for k in range(n)]


class NativeLatentStore(GanLatentStore):
    """`GanLatentStore` with its reads on C++ threads (module docstring)."""

    def __init__(self, index_path: str, root: Optional[str] = None, n_threads: int = 4,
                 seed: int = 0):
        super().__init__(index_path, root, seed)
        for files in self.by_prompt.values():
            for rel in files:
                if not rel.endswith(".npy"):
                    raise ValueError(f"{index_path}: {rel} is not a .npy file; the native "
                                     "store reads .npy only (GanLatentStore reads the rest)")
        self._lib = load_native()
        err = _err_buf()
        self._h = self._lib.ch_store_open(n_threads, err, _ERR_CAP)
        if not self._h:
            raise ValueError(err.value.decode())
        self._pending: Optional[List[int]] = None

    def prefetch(self, prompts: Sequence[str]) -> None:
        """Draw each prompt's file and queue the reads; returns at once."""
        if self._h is None:
            raise ValueError("the store is closed")
        if self._pending is not None:
            raise RuntimeError("gather() the prefetched batch first")
        paths = [self._path(self.rng.choice(self.by_prompt[p])).encode() for p in prompts]
        tickets = (ctypes.c_int64 * len(paths))()
        self._lib.ch_store_prefetch(self._h, (ctypes.c_char_p * len(paths))(*paths),
                                    len(paths), tickets)
        self._pending = list(tickets)

    def _fetch(self, ticket: int) -> np.ndarray:
        lib, err = self._lib, _err_buf()
        descr = ctypes.create_string_buffer(64)
        fortran, ndim = ctypes.c_int(), ctypes.c_int()
        shape = (ctypes.c_int64 * _MAX_DIMS)()
        nbytes = ctypes.c_int64()
        if lib.ch_store_fetch(self._h, ticket, descr, 64, ctypes.byref(fortran),
                              ctypes.byref(ndim), shape, _MAX_DIMS, ctypes.byref(nbytes),
                              err, _ERR_CAP):
            raise OSError(err.value.decode())
        dims = tuple(shape[:ndim.value])
        out = np.empty(dims, np.dtype(descr.value.decode()), order="F" if fortran.value else "C")
        if out.nbytes != nbytes.value:
            raise OSError(f"latent of {nbytes.value} bytes is not {dims} {out.dtype}")
        if lib.ch_store_take(self._h, ticket, out.ctypes.data, nbytes.value, err, _ERR_CAP):
            raise OSError(err.value.decode())
        return out

    def gather(self) -> np.ndarray:
        """Wait for the prefetched batch: the latents stacked, NHWC."""
        if self._pending is None:
            raise RuntimeError("prefetch() a batch first")
        tickets, self._pending = self._pending, None
        out, error = [], None
        for t in tickets:       # every ticket, so that a failed read leaves none behind
            try:
                out.append(to_nhwc(self._fetch(t)))
            except OSError as e:
                error = error or e
        if error is not None:
            raise error
        return np.stack(out)

    def batch(self, prompts: Sequence[str]) -> np.ndarray:
        self.prefetch(prompts)
        return self.gather()

    def close(self) -> None:
        if self._h is not None:
            self._lib.ch_store_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


class NativeCLIPTokenizer:
    """C++ CLIP BPE with `CLIPBPETokenizer.__call__`'s contract."""

    def __init__(self, vocab_path: str, merges_path: str,
                 pad_token_id: Optional[int] = None):
        self._lib = load_native()
        err = _err_buf()
        self._h = self._lib.ch_bpe_load(vocab_path.encode(), merges_path.encode(), err,
                                        _ERR_CAP)
        if not self._h:
            raise ValueError(err.value.decode())
        self.vocab_path, self.merges_path = vocab_path, merges_path
        self.bos_token_id = self._lib.ch_bpe_bos(self._h)
        self.eos_token_id = self._lib.ch_bpe_eos(self._h)
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self._py: Optional[CLIPBPETokenizer] = None

    def encode_to_tokens(self, text: str) -> List[str]:
        """Wordpiece strings with BOS and EOS (linguistics.get_indices reads
        them): the Python tokenizer's, over the same files."""
        if self._py is None:
            self._py = CLIPBPETokenizer(self.vocab_path, self.merges_path,
                                        pad_token_id=self.pad_token_id)
        return self._py.encode_to_tokens(text)

    def __call__(self, texts: Sequence[str], max_length: int = 77) -> Dict[str, np.ndarray]:
        n = len(texts)
        raw = [clean_text(t).encode("utf-8") for t in texts]
        out = np.empty((n, max_length), np.int32)
        eos = np.empty((n,), np.int32)
        err = _err_buf()
        if self._lib.ch_bpe_encode_batch(
                self._h, (ctypes.c_char_p * n)(*raw), (ctypes.c_int64 * n)(*map(len, raw)), n,
                max_length, self.pad_token_id,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                eos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, _ERR_CAP):
            msg = err.value.decode()
            raise (KeyError if "not in the vocabulary" in msg else ValueError)(msg)
        return {"input_ids": out, "eos_positions": eos}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ch_bpe_free(self._h)
            self._h = None
