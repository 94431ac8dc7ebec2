"""The port stands alone: importing every comat_tpu_torch module loads no
jax and no comat_tpu module, and an entry point asked for no device on a
machine without CUDA raises instead of running on the CPU."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "comat_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert {"comat_tpu_torch.ops.flash_attention", "comat_tpu_torch.models.blip",
            "comat_tpu_torch.losses.caption_reward",
            "comat_tpu_torch.training.train_step",
            "comat_tpu_torch.losses.gan", "comat_tpu_torch.losses.grounding",
            "comat_tpu_torch.training.attrcon",
            "comat_tpu_torch.segmentation.interface",
            "comat_tpu_torch.text.linguistics", "comat_tpu_torch.text.miniparse",
            "comat_tpu_torch.text.parse_cache", "comat_tpu_torch.train",
            "comat_tpu_torch.training.trainer", "comat_tpu_torch.training.arguments",
            "comat_tpu_torch.training.data", "comat_tpu_torch.training.checkpoints",
            "comat_tpu_torch.training.logging_utils",
            "comat_tpu_torch.models.remat",
            "comat_tpu_torch.ops.deformable_attention",
            "comat_tpu_torch.segmentation.layers", "comat_tpu_torch.segmentation.swin",
            "comat_tpu_torch.segmentation.gdino", "comat_tpu_torch.segmentation.fastsam",
            "comat_tpu_torch.segmentation.grounded_sam",
            "comat_tpu_torch.segmentation.checkpoints",
            "comat_tpu_torch.segmentation.gdino_import_hf",
            "comat_tpu_torch.models.hf_import", "comat_tpu_torch.models.blip_vqa",
            "comat_tpu_torch.tools.gan_gt_generate",
            "comat_tpu_torch.tools.evaluate", "comat_tpu_torch.models.quant",
            "comat_tpu_torch.ops.quant", "comat_tpu_torch.tools.stability_run",
            "comat_tpu_torch.tools.parse_stats", "comat_tpu_torch.parallel.mesh",
            "comat_tpu_torch.parallel.tp", "comat_tpu_torch.native_host",
            "comat_tpu_torch.tools.gen_unicode_classes"} <= set(mods)
    res = _run(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "comat_tpu" or m.startswith("comat_tpu.")]
        print("BAD", bad)
    """)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|comat_tpu)(\.|\s|$)", re.M)
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_native_host_loads_its_own_library():
    """The port's host library is built from its own source into
    build/host/, never JAX's native/libcomat_host.so."""
    res = _run("""
        import sys
        from comat_tpu_torch import native_host
        lib = native_host.load_native()
        print("LIB", lib._name)
        print("BAD", [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "comat_tpu" or m.startswith("comat_tpu.")])
    """)
    assert res.returncode == 0, res.stderr
    lib = res.stdout.split("LIB ", 1)[1].split()[0]
    assert pathlib.Path(lib).parent == REPO / "build" / "host", lib
    assert pathlib.Path(lib).name.startswith("libcomat_host-"), lib
    assert "BAD []" in res.stdout, res.stdout
    assert "native/" not in (PKG / "native_host.py").read_text()


def test_entry_points_refuse_to_fall_back_to_cpu():
    res = _run("""
        import torch
        assert not torch.cuda.is_available()
        from comat_tpu_torch.models.pipeline import (
            DiffusionPipeline, make_pipeline_config)
        from comat_tpu_torch.tools.generate import main
        from comat_tpu_torch.config import BLIPConfig
        from comat_tpu_torch.models.blip import make_blip
        from comat_tpu_torch.train import main as train_main
        from comat_tpu_torch.segmentation.grounded_sam import GroundedSAMSegmenter
        from comat_tpu_torch.tools.evaluate import main as eval_main
        from comat_tpu_torch.tools.gan_gt_generate import main as gan_main
        cfg = make_pipeline_config("sd_1_5", lora_rank=0, resolution=64, tiny=True)
        xl = make_pipeline_config("sdxl", lora_rank=0, resolution=64, tiny=True)
        for call in (lambda: DiffusionPipeline(cfg), lambda: GroundedSAMSegmenter(),
                     lambda: main(["--tiny", "--prompt", "a cat"]),
                     lambda: make_blip(BLIPConfig.tiny()),
                     lambda: train_main(["--tiny_models", "--training_prompts",
                                         "collected_data/abc5k.txt",
                                         "--output_dir", "build/no_card"]),
                     lambda: DiffusionPipeline(xl),
                     lambda: main(["--tiny", "--model", "sdxl", "--prompt", "a cat"]),
                     lambda: train_main(["--tiny_models", "--training_prompts",
                                         "collected_data/abc5k.txt",
                                         "--pretrain_model_name", "sdxl_attrcon_unet",
                                         "--output_dir", "build/no_card"]),
                     lambda: gan_main(["--tiny", "--prompt-path", "collected_data/abc5k.txt",
                                       "--end", "2", "--save-path", "build/no_card/store"]),
                     lambda: eval_main(["--tiny", "--prompt-path", "collected_data/abc5k.txt",
                                        "--max-prompts", "2"])):
            try:
                call()
            except RuntimeError as e:
                print("RAISED", e)
            else:
                print("RAN")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("RAISED") == 10, res.stdout
