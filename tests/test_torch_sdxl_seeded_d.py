"""Pins a known JAX-side departure from the original CoMat: under an SDXL
generator the published recipe's SD1.5-architecture discriminator
(--gan_model_arch gansd_1_5) keeps seeded weights in JAX
(comat_tpu/training/trainer.py:333-338), where the reference loads the
SD1.5 snapshot into it. The port follows JAX: its trainer warns, and D's
UNet is the one `Discriminator` draws from seed + 2, a tower of its own
that shares no tensor with the generator (tiny geometry, on the CPU)."""

import pytest
import torch

from comat_tpu_torch.config import UNetConfig
from comat_tpu_torch.losses.gan import Discriminator
from comat_tpu_torch.training.arguments import parse_args
from comat_tpu_torch.training.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker, so that parallel test files do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sdxl_cross_architecture_d_stays_seeded_and_warns(tmp_path):
    (tmp_path / "p.txt").write_text("a red cube\na blue ball\n")
    out = tmp_path / "out"
    seed = 7
    trainer = Trainer(parse_args([
        "--training_prompts", str(tmp_path / "p.txt"), "--output_dir", str(out),
        "--tiny_models", "--device", "cpu", "--pretrain_model_name", "sdxl",
        "--resolution", "64", "--train_batch_size", "2", "--lora_rank", "4",
        "--gan_loss", "--gan_model_arch", "gansd_1_5", "--seed", str(seed),
        "--report_to", "none"]))
    log = (out / "log.txt").read_text()
    assert "discriminator's UNet is seeded, as in JAX" in log
    disc = trainer.disc
    assert disc.gan_cfg.cross_arch and trainer.pcfg.is_sdxl
    g_ids = {id(p) for p in trainer.pipeline.unet.parameters()}
    assert not any(id(p) in g_ids for p in disc.parameters())
    want = Discriminator(UNetConfig.tiny(cross_attention_dim=trainer.pcfg.text.hidden_size),
                         disc.gan_cfg, "cpu", seed=seed + 2)
    got_sd, want_sd = disc.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[n], want_sd[n]) for n in got_sd)
