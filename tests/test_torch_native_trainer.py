"""The trainer takes the native host pieces (`native_host.py`) where JAX's
trainer takes its own, and a step on them is the step on the Python
pieces, bit for bit.

At tiny geometry on the CPU, with the GAN and attribute concentration:
--tokenizer_dir (a byte-level vocabulary whose ids fit the tiny text
tower) gives a `NativeCLIPTokenizer`, --gan_gt_path over .npy files (NHWC,
NCHW and prompts with two latents) a `NativeLatentStore`; two steps of
that trainer equal two steps of a second one whose `clip_tok` and
`latent_store` were swapped for `CLIPBPETokenizer` and `GanLatentStore`
over the same files: the losses, and every G and D tensor after. An
index with a .pt entry gives `GanLatentStore` and one log line naming the
file.
"""

import json
import logging

import numpy as np
import pytest
import torch

from comat_tpu_torch.native_host import NativeCLIPTokenizer, NativeLatentStore
from comat_tpu_torch.text.tokenizer import CLIPBPETokenizer
from comat_tpu_torch.training import arguments as targs
from comat_tpu_torch.training.data import GanLatentStore
from comat_tpu_torch.training.trainer import Trainer
from test_torch_native_host import write_byte_vocab

PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse", "three white cups on a table",
           "a black dog under an orange tree", "four pink flowers in a vase café"]
RUN = ["--tiny_models", "--device", "cpu", "--pretrain_model_name", "sd_1_5_attrcon",
       "--resolution", "64", "--train_batch_size", "2", "--total_step", "4", "--K", "2",
       "--lora_rank", "4", "--gan_loss", "--seed", "42", "--report_to", "none"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _store(root, pt=False):
    """Every prompt's latents: .npy NHWC, the third NCHW, the even ones a
    second latent (a .pt one with `pt`)."""
    rng = np.random.default_rng(5)
    root.mkdir()
    with open(root / "index.jsonl", "w") as f:
        for i, p in enumerate(PROMPTS):
            lat = rng.standard_normal((8, 8, 4), np.float32)
            np.save(root / f"l{i}.npy", lat.transpose(2, 0, 1) if i == 2 else lat)
            names = [f"l{i}.npy"]
            if i % 2 == 0:
                second = f"l{i}b.pt" if pt else f"l{i}b.npy"
                if pt:
                    torch.save(torch.from_numpy(rng.standard_normal((4, 8, 8), np.float32)),
                               root / second)
                else:
                    np.save(root / second, rng.standard_normal((8, 8, 4), np.float32))
                names.append(second)
            for name in names:
                f.write(json.dumps({"prompt": p, "file_path": name}) + "\n")
    return str(root / "index.jsonl")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_trainer")
    (root / "p.txt").write_text("\n".join(PROMPTS))
    vocab, merges = write_byte_vocab(str(root / "tok"), PROMPTS, n_merges=60, bos=998,
                                     eos=999)
    return root, vocab, merges, _store(root / "store")


def _trainer(files, tag, *extra):
    root, vocab, _, index = files
    return Trainer(targs.parse_args(
        ["--training_prompts", str(root / "p.txt"), "--output_dir", str(root / tag), *RUN,
         "--tokenizer_dir", str(root / "tok"), "--gan_gt_path", index, *extra]))


def _two_steps(trainer):
    prompts = iter(trainer.dataset.epoch(0))
    losses = [trainer.train_one(next(prompts))["step_loss"] for _ in range(2)]
    return (losses, {n: p.detach().clone() for n, p in trainer.state.trainable.items()},
            {n: p.detach().clone() for n, p in trainer.d_state.trainable.items()})


def test_native_pieces_train_as_the_python_pieces_bit_for_bit(files):
    _, vocab, merges, index = files
    native = _trainer(files, "native")
    assert isinstance(native.clip_tok, NativeCLIPTokenizer)
    assert isinstance(native.latent_store, NativeLatentStore)
    a = _two_steps(native)
    python = _trainer(files, "python")
    python.clip_tok = CLIPBPETokenizer(vocab, merges)
    python.latent_store = GanLatentStore(index)
    b = _two_steps(python)
    assert a[0] == b[0] and all(np.isfinite(a[0]))
    for got, want in zip(a[1:], b[1:]):
        assert got.keys() == want.keys() and len(got) > 10
        assert all(torch.equal(got[n], want[n]) for n in got)
    assert native.latent_store.rng.getstate() == python.latent_store.rng.getstate()


def test_a_store_with_a_pt_entry_is_read_by_the_python_store(files, tmp_path, caplog):
    index = _store(tmp_path / "store", pt=True)
    with caplog.at_level(logging.INFO):
        trainer = _trainer(files, "pt", "--gan_gt_path", index)
    assert type(trainer.latent_store) is GanLatentStore
    lines = [r.getMessage() for r in caplog.records if "latent store" in r.getMessage()]
    assert len(lines) == 1 and "l0b.pt" in lines[0], lines
