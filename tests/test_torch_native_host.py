"""The port's native host runtime (`comat_tpu_torch/native_host.py`,
`csrc/comat_host.cpp`, built here by g++) against the port's Python
pieces, and against JAX's native module where the two agree.

- The C++ pretokenizer against `_CLIP_PAT.findall` on every Unicode code
  point, in runs and in the contexts the pattern's alternatives turn on
  (letters, apostrophes, digits, the special tokens).
- `NativeCLIPTokenizer` against the port's `CLIPBPETokenizer` on every
  line of the three corpora, padding with EOS and with 0, over a
  byte-level vocabulary (all 256 byte symbols, their `</w>` forms and
  merges learned from the corpus).
- JAX's `comat_tpu.native_host.NativeCLIPTokenizer` (on the committed
  native/libcomat_host.so) equals the port's on the ASCII prompts; on the
  non-ASCII ones it departs, and JAX's Python tokenizer gives the port's
  ids there. "a_b" and "日本" follow JAX's Python tokenizer.
- `NativeLatentStore` against `GanLatentStore` from the same seed on the
  same prompts: NHWC and NCHW files, prompts with several latents, a
  restored `rng`; the errors.
"""

import collections
import json
import os
import random

import numpy as np
import pytest

from comat_tpu_torch import native_host as nh
from comat_tpu_torch.ops import _build
from comat_tpu_torch.text.tokenizer import _CLIP_PAT, CLIPBPETokenizer, bytes_to_unicode
from comat_tpu_torch.training.data import GanLatentStore, load_prompts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPORA = ["collected_data/abc5k.txt", "collected_data/train_all.txt",
           "merged_data/abc5k_hrs10k_t2icompall_20k.txt"]
NON_ASCII = ["café", "piñata", "sautéing"]


def write_byte_vocab(path, lines, n_merges=300, bos=49406, eos=49407, ensure_ascii=True):
    """A byte-level CLIP vocabulary in `path` (vocab.json, merges.txt): the
    256 byte symbols, their `</w>` forms, and `n_merges` merges learned
    greedily (most frequent pair first) from the words of `lines`."""
    enc = bytes_to_unicode()
    symbols = [enc[b] for b in range(256)]
    words = collections.Counter()
    for line in lines:
        for tok in _CLIP_PAT.findall(line.lower()):
            sym = [enc[b] for b in tok.encode("utf-8")]
            words[tuple(sym[:-1] + [sym[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for a, b in zip(w, w[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    vocab = {}
    for tok in symbols + [s + "</w>" for s in symbols] + [a + b for a, b in merges]:
        vocab.setdefault(tok, len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = bos, eos
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=ensure_ascii)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")


@pytest.fixture(scope="module")
def corpora():
    return {c: load_prompts(os.path.join(REPO, c)) for c in CORPORA}


@pytest.fixture(scope="module")
def vocab(tmp_path_factory, corpora):
    sample = corpora[CORPORA[0]][:2000] + [p for p in corpora[CORPORA[2]] if not p.isascii()]
    return write_byte_vocab(str(tmp_path_factory.mktemp("vocab")), sample,
                            ensure_ascii=False)


# ---- the pretokenizer ----

_CODE_POINTS = [cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF]
_CONTEXTS = {
    "run": "{}",
    "between_letters": "a{}b",
    "after_apostrophe": "'{}",
    "apostrophe_contraction": "'{}e",
    "special_token": "<|{}tartoftext|>",
    "after_digit": "1{}!",
}


@pytest.mark.parametrize("context", sorted(_CONTEXTS))
def test_pretokenizer_equals_clip_pattern_on_every_code_point(context):
    form = _CONTEXTS[context]
    for i in range(0, len(_CODE_POINTS), 4096):
        block = _CODE_POINTS[i:i + 4096]
        text = " ".join(form.format(chr(c)) for c in block) if context != "run" else \
            "".join(chr(c) for c in block)
        assert nh.pretokenize(text) == _CLIP_PAT.findall(text), (context, hex(block[0]))


def test_pretokenizer_equals_clip_pattern_on_random_text():
    rng = random.Random(0)
    pool = ([cp for cp in _CODE_POINTS if cp < 0x3000] + list(range(0x20, 0x7F)) * 30
            + [ord("'")] * 200 + [0x17F, 0x212A, 0x130, 0] * 20)
    for _ in range(3000):
        text = "".join(chr(rng.choice(pool)) for _ in range(rng.randint(1, 60)))
        assert nh.pretokenize(text) == _CLIP_PAT.findall(text), repr(text)


def test_unicode_table_is_this_interpreters():
    import unicodedata

    assert nh.load_native().ch_unicode_version().decode() == unicodedata.unidata_version


# ---- the tokenizer ----

@pytest.mark.parametrize("pad", [None, 0])
@pytest.mark.parametrize("corpus", CORPORA)
def test_native_ids_equal_python_on_the_corpora(vocab, corpora, corpus, pad):
    prompts = corpora[corpus]
    py = CLIPBPETokenizer(*vocab, pad_token_id=pad)
    native = nh.NativeCLIPTokenizer(*vocab, pad_token_id=pad)
    for i in range(0, len(prompts), 512):
        batch = prompts[i:i + 512]
        a, b = native(batch), py(batch)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["eos_positions"], b["eos_positions"])
    assert native.pad_token_id == py.pad_token_id
    assert (native.bos_token_id, native.eos_token_id) == (py.bos_token_id, py.eos_token_id)


def test_native_truncates_and_pads_as_python(vocab, corpora):
    prompts = corpora[CORPORA[2]][:200] + ["", "   ", "&amp;lt;b&amp;gt; tags", "a\tb\nc"]
    py, native = CLIPBPETokenizer(*vocab), nh.NativeCLIPTokenizer(*vocab)
    for length in (8, 16, 77):
        a, b = native(prompts, max_length=length), py(prompts, max_length=length)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["eos_positions"], b["eos_positions"])


def test_encode_to_tokens_equals_python(vocab, corpora):
    py, native = CLIPBPETokenizer(*vocab), nh.NativeCLIPTokenizer(*vocab)
    for p in corpora[CORPORA[0]][:300] + NON_ASCII:
        assert native.encode_to_tokens(p) == py.encode_to_tokens(p)


def test_escaped_vocab_json_loads_the_same(tmp_path, vocab):
    plain = nh.NativeCLIPTokenizer(*vocab)
    with open(vocab[0], encoding="utf-8") as f:
        table = json.load(f)
    escaped = tmp_path / "vocab.json"
    escaped.write_text(json.dumps(table, ensure_ascii=True))
    native = nh.NativeCLIPTokenizer(str(escaped), vocab[1])
    prompts = ["a red café", "piñata", "the \"quoted\" word"]
    np.testing.assert_array_equal(native(prompts)["input_ids"], plain(prompts)["input_ids"])


def test_bad_files_raise_with_a_message(tmp_path, vocab):
    bad = tmp_path / "merges.txt"
    bad.write_text("#version\na b c\n")
    with pytest.raises(ValueError, match="not two symbols"):
        nh.NativeCLIPTokenizer(vocab[0], str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        nh.NativeCLIPTokenizer(str(tmp_path / "missing.json"), vocab[1])
    (tmp_path / "v.json").write_text('{"a": 1,')
    with pytest.raises(ValueError, match="vocab.json"):
        nh.NativeCLIPTokenizer(str(tmp_path / "v.json"), vocab[1])


def test_a_piece_missing_from_the_vocabulary_raises_as_python(tmp_path):
    path = tmp_path / "v"
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps({"a</w>": 0, "<|endoftext|>": 1}))
    (path / "merges.txt").write_text("#version\n")
    args = (str(path / "vocab.json"), str(path / "merges.txt"))
    with pytest.raises(KeyError):
        CLIPBPETokenizer(*args)(["b"])
    with pytest.raises(KeyError, match="not in the vocabulary"):
        nh.NativeCLIPTokenizer(*args)(["b"])


@pytest.mark.parametrize("text", ["a_b", "snake_case_name", "日本", "東京 タワー"])
def test_underscore_and_cjk_follow_jaxs_python_tokenizer(vocab, text):
    """`[^\\s\\w']+` leaves "_" out of every token (transformers' CLIPTokenizer
    keeps it), and CJK letters run as one word: the native ids are the
    Python tokenizer's, JAX's and the port's."""
    from comat_tpu.text.tokenizer import CLIPBPETokenizer as JaxCLIPBPETokenizer

    native = nh.NativeCLIPTokenizer(*vocab)([text])["input_ids"]
    np.testing.assert_array_equal(native, CLIPBPETokenizer(*vocab)([text])["input_ids"])
    np.testing.assert_array_equal(native, JaxCLIPBPETokenizer(*vocab)([text])["input_ids"])
    if "_" in text:
        assert "_" not in "".join(_CLIP_PAT.findall(text))


@pytest.fixture(scope="module")
def jax_native(vocab):
    from comat_tpu import native_host as jnh

    try:
        lib = jnh.load_native()
    except OSError as e:
        pytest.skip(f"native/libcomat_host.so does not load here: {e}")
    if lib is None:
        pytest.skip("native/libcomat_host.so is not built")
    return jnh.NativeCLIPTokenizer(*vocab)


def test_jax_native_tokenizer_agrees_on_ascii_and_parts_on_the_rest(jax_native, vocab, corpora):
    from comat_tpu.text.tokenizer import CLIPBPETokenizer as JaxCLIPBPETokenizer

    native = nh.NativeCLIPTokenizer(*vocab)
    jax_py = JaxCLIPBPETokenizer(*vocab)
    ascii_prompts = [p for c in CORPORA for p in corpora[c] if p.isascii()]
    for i in range(0, len(ascii_prompts), 1024):
        batch = ascii_prompts[i:i + 1024]
        np.testing.assert_array_equal(jax_native(batch)["input_ids"],
                                      native(batch)["input_ids"])
    others = sorted({p for c in CORPORA for p in corpora[c] if not p.isascii()})
    assert len([p for p in corpora[CORPORA[2]] if not p.isascii()]) == 4
    assert all(any(w in p for w in NON_ASCII) for p in others)
    ours, theirs = native(others)["input_ids"], jax_native(others)["input_ids"]
    assert all((ours[i] != theirs[i]).any() for i in range(len(others)))
    np.testing.assert_array_equal(ours, jax_py(others)["input_ids"])


# ---- the latent store ----

@pytest.fixture
def store(tmp_path):
    """An index of 6 prompts: NHWC float32 files, one NCHW file, two
    prompts with several latents (one of them float16), absolute and
    relative paths."""
    rng = np.random.RandomState(0)
    (tmp_path / "latents").mkdir()
    lines = []
    for i in range(6):
        prompt = f"prompt {i}"
        for k in range(1 + (i in (1, 4)) + (i == 4)):
            name = f"latents/l{i}_{k}.npy"
            lat = rng.randn(8, 8, 4).astype(np.float16 if (i, k) == (4, 2) else np.float32)
            if i == 2:
                lat = np.ascontiguousarray(lat.transpose(2, 0, 1))   # NCHW, the reference's
            np.save(tmp_path / name, lat)
            path = str(tmp_path / name) if i == 5 else name
            lines.append(json.dumps({"prompt": prompt, "file_path": path}))
    index = tmp_path / "index.jsonl"
    index.write_text("\n".join(lines) + "\n")
    return str(index)


def _sequence(seed=1, n=40):
    r = random.Random(seed)
    return [[f"prompt {r.randrange(6)}" for _ in range(3)] for _ in range(n)]


def test_native_store_equals_gan_latent_store(store):
    native, py = nh.NativeLatentStore(store, n_threads=3), GanLatentStore(store)
    assert native.prompts() == py.prompts()
    for prompts in _sequence():
        a, b = native.batch(prompts), py.batch(prompts)
        assert a.dtype == b.dtype and a.shape == b.shape == (3, 8, 8, 4)
        np.testing.assert_array_equal(a, b)
    assert native.rng.getstate() == py.rng.getstate()
    native.close()


def test_prefetch_then_gather_is_batch(store):
    native, py = nh.NativeLatentStore(store), GanLatentStore(store)
    for prompts in _sequence(2, 10):
        native.prefetch(prompts)
        np.testing.assert_array_equal(native.gather(), py.batch(prompts))
    with pytest.raises(RuntimeError):
        native.gather()


def test_many_reader_threads_under_load_keep_every_batch(store):
    """More reader threads than cores and batches queued while others are
    gathered: every batch is the Python store's, within a bounded time."""
    import threading

    native, py = nh.NativeLatentStore(store, n_threads=4 * (os.cpu_count() or 8)), \
        GanLatentStore(store)
    seq = _sequence(4, 300)
    seq = [b * 6 for b in seq]          # 18 reads a batch
    got, want = [], [py.batch(b) for b in seq]

    def work():
        for prompts in seq:
            native.prefetch(prompts)
            got.append(native.gather())

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    native.close()


def test_restored_rng_continues_the_sequence(store):
    first, ref = nh.NativeLatentStore(store), GanLatentStore(store)
    seq = _sequence(3, 20)
    for prompts in seq[:7]:
        first.batch(prompts)
        ref.batch(prompts)
    state = first.rng.getstate()
    resumed = nh.NativeLatentStore(store)
    resumed.rng.setstate(state)
    for prompts in seq[7:]:
        np.testing.assert_array_equal(resumed.batch(prompts), ref.batch(prompts))


def test_unknown_prompt_and_non_npy_entries_raise(store, tmp_path):
    native = nh.NativeLatentStore(store)
    with pytest.raises(KeyError):
        native.batch(["no such prompt"])
    pt = tmp_path / "pt_index.jsonl"
    pt.write_text(json.dumps({"prompt": "p", "file_path": "latents/x.npy"}) + "\n"
                  + json.dumps({"prompt": "q", "file_path": "latents/y.pt"}) + "\n")
    with pytest.raises(ValueError, match="latents/y.pt"):
        nh.NativeLatentStore(str(pt))


def test_a_bad_file_raises_with_its_path(tmp_path):
    (tmp_path / "a.npy").write_bytes(b"not numpy")
    np.save(tmp_path / "b.npy", np.zeros((2, 2), np.float32))
    with open(tmp_path / "b.npy", "r+b") as f:
        f.truncate(100)
    index = tmp_path / "index.jsonl"
    index.write_text(json.dumps({"prompt": "a", "file_path": "a.npy"}) + "\n"
                     + json.dumps({"prompt": "b", "file_path": "b.npy"}) + "\n"
                     + json.dumps({"prompt": "c", "file_path": "missing.npy"}) + "\n")
    good = np.arange(8, dtype=np.float32).reshape(2, 4)
    np.save(tmp_path / "d.npy", good)
    with open(index, "a") as f:
        f.write(json.dumps({"prompt": "d", "file_path": "d.npy"}) + "\n")
    native = nh.NativeLatentStore(str(index))
    for prompt, why in (("a", "not a .npy"), ("b", "truncated"), ("c", "cannot open")):
        with pytest.raises(OSError, match=why):
            native.batch(["d", prompt, "d"])
    # the failed batches left nothing queued: the next one reads
    np.testing.assert_array_equal(native.batch(["d"])[0], good)


def test_a_failed_host_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="host build of broken.cpp failed"):
        _build.build_host("broken")
    assert not os.listdir(tmp_path / "out")
