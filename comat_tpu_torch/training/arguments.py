"""Training CLI flags: the reference's public flag surface.

The port's own copy of comat_tpu/training/arguments.py (the ~65-flag
contract that scripts/sd15.sh drives; the same flags, defaults and parse
results), plus `--device` (default cuda). Flags whose paths the port
does not have yet raise `NotImplementedError` naming their ROADMAP Queue
1 item when set (`_check_ported`); the reference's CUDA-only flags are
accepted as the JAX package accepts them. `launcher_argv` reads the
flags of a launcher script such as scripts/sd15.sh.
"""

from __future__ import annotations

import argparse
import re
import shlex
from typing import List

_SURFACES = "ROADMAP Queue 1: trainable surfaces and the optimizer"
_LOADERS = "ROADMAP Queue 1: snapshot loaders, tested on synthetic snapshots"
_DDP = "ROADMAP Queue 1: torch DDP with gradient accumulation"
_SDXL = "ROADMAP Queue 1: SDXL"


def _check_ported(args) -> None:
    """Raise for a set flag whose path is not ported, naming its item."""
    unported = [
        ("--full_finetuning", args.full_finetuning, _SURFACES),
        ("--train_text_encoder_lora", args.train_text_encoder_lora, _SURFACES),
        ("--use_8bit_adam", args.use_8bit_adam,
         "ROADMAP Queue 1: opt-in extras (8-bit Adam)"),
        ("--pass1_int8", args.pass1_int8, "ROADMAP Queue 1: opt-in extras (W8A8 pass 1)"),
        ("--prediction_type", args.prediction_type not in (None, "epsilon"),
         "ROADMAP Queue 1: opt-in extras (v-prediction)"),
        ("--mesh_model_axis", args.mesh_model_axis > 1,
         "ROADMAP Queue 1: opt-in extras (parallel/tp.py)"),
        ("--gradient_accumulation_steps", args.gradient_accumulation_steps > 1, _DDP),
        ("--pretrain_model_name", args.pretrain_model_name.startswith("sdxl"), _SDXL),
        ("--sdxl_unet_path", args.sdxl_unet_path, _SDXL),
        ("--blip_tokenizer_vocab", args.blip_tokenizer_vocab, _LOADERS),
        ("--caption_model_path", args.caption_model_path, _LOADERS),
    ]
    for flag, is_set, item in unported:
        if is_set:
            raise NotImplementedError(f"{flag}: not ported yet, {item}")


def launcher_argv(path: str) -> List[str]:
    """The flags a launcher script passes to its trainer with the
    script's own defaults: its one command (line continuations joined),
    split as the shell splits it, without the interpreter and module and
    without "$@", each ${NAME:-default} as its default (whatever NAME
    the caller's environment holds)."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith(("python ", "python3 ")))
    words = shlex.split(line)
    words = words[3:] if words[1] == "-m" else words[2:]

    def expand(w: str) -> str:
        return re.sub(r"\$\{(\w+):-([^}]*)\}", lambda m: m.group(2), w)

    return [expand(w) for w in words if w != "$@"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CoMat training (PyTorch port)")

    # --- model ---
    p.add_argument("--pretrain_model", type=str,
                   default="runwayml/stable-diffusion-v1-5",
                   help="checkpoint path or HF snapshot dir")
    p.add_argument("--pretrain_model_name", type=str, default="sd_1_5",
                   choices=["sd_1_5", "sd_1_5_attrcon", "sdxl", "sdxl_unet",
                            "sdxl_attrcon", "sdxl_attrcon_unet"])
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--sdxl_unet_path", type=str, default=None)
    p.add_argument("--prediction_type", type=str, default=None)

    # --- method ---
    p.add_argument("--caption_model", type=str, default="Blip", nargs="+")
    p.add_argument("--reward_weights", type=float, default=None, nargs="+")
    p.add_argument("--seg_model", type=str, default="gsam")
    # Segmentation weights (the reference hardcodes FastSAM-x.pt and
    # the GroundingDINO swin-t release — gsam_interface.py:24-37)
    p.add_argument("--fastsam_checkpoint", type=str, default=None,
                   help="FastSAM-x .pt (or re-exported state dict)")
    p.add_argument("--gdino_checkpoint", type=str, default=None,
                   help="groundingdino_swint_ogc.pth")
    p.add_argument("--gdino_tokenizer_vocab", type=str, default=None,
                   help="bert-base-uncased vocab.txt for GroundingDINO")
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--total_step", type=int, default=50)
    p.add_argument("--scheduler", type=str, default="DDPM")
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--cfg_rescale", type=float, default=0.0)
    p.add_argument("--bp_on_trained", action="store_true")
    p.add_argument("--attrcon_train_steps", type=int, default=2)
    p.add_argument("--mask_token_loss_weight", type=float, default=1e-3)
    p.add_argument("--mask_pixel_loss_weight", type=float, default=5e-5)
    p.add_argument("--norm_grad", action="store_true")
    p.add_argument("--batch_repeat", type=int, default=1)

    # --- GAN ---
    p.add_argument("--gan_loss", action="store_true")
    p.add_argument("--gan_model_arch", type=str, default="sd_1_5")
    p.add_argument("--gan_loss_weight", type=float, default=1.0)
    p.add_argument("--condition_discriminator", action="store_true")
    p.add_argument("--gan_unet_lastlayer_cls", action="store_true")
    p.add_argument("--gan_gt_path", type=str, default=None,
                   help="jsonl index of pre-generated latents "
                        "(tools/gan_gt_generate.py output)")
    p.add_argument("--learning_rate_D", type=float, default=2e-5)
    p.add_argument("--adam_beta1_D", type=float, default=0.0)
    p.add_argument("--adam_beta2_D", type=float, default=0.999)
    p.add_argument("--max_grad_norm_D", type=float, default=1.0)

    # --- trainable surface ---
    p.add_argument("--full_finetuning", action="store_true")
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--tune_vae", action="store_true")
    p.add_argument("--tune_text_encoder", action="store_true")
    p.add_argument("--train_text_encoder_lora", action="store_true")
    p.add_argument("--textenc_lora_lr", type=float, default=None)

    # --- optimization ---
    p.add_argument("--learning_rate", type=float, default=5e-5)
    # accepted-but-unused in the reference too (defined at
    # arguments.py:74-79, never read by training_script.py)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="int8 blockwise optimizer moments; not ported")
    p.add_argument("--allow_tf32", action="store_true",
                   help="matmuls may use TF32 (cuDNN convs do by default)")
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=[None, "no", "fp16", "bf16"],
                   help="accepted; the towers run bf16 with fp32 LoRA")
    p.add_argument("--gradient_checkpointing", action="store_true")
    # no reference analogue: selective remat, only UNet blocks at
    # spatial res >= this recompute (and the decoder per block)
    p.add_argument("--remat_min_res", type=int, default=None)
    p.add_argument("--pass1_int8", action="store_true",
                   help="W8A8 int8 numerics for the no-grad pass-1 "
                        "sampling forwards (models/quant.py); the "
                        "differentiable replay stays bf16/fp32. "
                        "not ported")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    # the reference's only branch is AdamW (training_script.py:
    # 224-225); 8-bit selection goes through --use_8bit_adam
    p.add_argument("--optimizer_class", type=str, default="AdamW",
                   choices=["AdamW"])

    # --- data ---
    p.add_argument("--training_prompts", type=str, required=True)
    # accepted for parity: the reference loads images for JSON
    # datasets with a file_name column (dataset.py:26-32) but the
    # training loop never consumes batch["image"] — CoMat trains
    # on prompts only (online generation)
    p.add_argument("--image_folder", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--max_train_samples", type=int, default=None)

    # --- run ---
    p.add_argument("--output_dir", type=str, default="comat-output")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="HF-style cache root searched for model "
                        "snapshots when --pretrain_model is a repo id")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--seed", type=int, default=None)
    # None -> derived from --num_train_epochs (reference
    # training_script.py:287-288)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--num_train_epochs", type=int, default=100)
    # nargs="+" prompt strings, optionally extended by a file — the
    # reference's exact contract (arguments.py:44-55,
    # training_script.py:458-463)
    p.add_argument("--validation_prompts", type=str, default=None,
                   nargs="+")
    p.add_argument("--validation_prompts_file", type=str, default=None)
    p.add_argument("--validation_steps", type=int, default=100)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--tracker_project_name", type=str,
                   default="comat-tpu")
    p.add_argument("--local_rank", type=int, default=-1,
                   help="accepted for launcher parity; unused "
                        "(single process)")
    # reference flags accepted as no-ops: the flash-attention kernel is
    # always on here, which is what these flags enable in the reference
    # (training_script.py:135-146)
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true",
                   help="no-op: the flash kernel is always on")
    p.add_argument("--enable_torch2_product", action="store_true",
                   help="no-op: the flash kernel is always on")

    # --- extras (no reference equivalent) ---
    p.add_argument("--tokenizer_dir", type=str, default=None,
                   help="local CLIP tokenizer files (vocab.json+merges)")
    p.add_argument("--tokenizer2_dir", type=str, default=None,
                   help="SDXL tokenizer_2 files (defaults to "
                        "--tokenizer_dir; same BPE, pad token '!'=0)")
    p.add_argument("--blip_tokenizer_vocab", type=str, default=None)
    p.add_argument("--tiny_models", action="store_true",
                   help="CPU-runnable tiny geometry (testing)")
    p.add_argument("--precomputed_masks", type=str, default=None,
                   help=".npz of per-noun masks for attribute "
                        "concentration (offline segmentation)")
    p.add_argument("--parse_cache", type=str, default=None,
                   help="jsonl dependency-parse cache exported by "
                        "tools/parse_stats export on a spacy-equipped "
                        "host (en_core_web_trf, the reference's "
                        "parser); parse_prompt consumes it verbatim")
    p.add_argument("--mesh_model_axis", type=int, default=1)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace of steps 4-7 (chrome trace json)")
    p.add_argument("--caption_model_path", type=str, default=None,
                   help="local snapshot dir for the frozen caption "
                        "reward model (Salesforce/blip-image-"
                        "captioning-large); a repo id resolves "
                        "through --cache_dir")
    p.add_argument("--allow_smoke", action="store_true",
                   help="permit fidelity-degrading fallbacks (hash "
                        "tokenizer, zero GAN-GT latents, random "
                        "caption-model weights) in non-tiny runs — "
                        "smoke testing only")

    # --- the port ---
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises without a card")

    args = p.parse_args(argv)
    _check_ported(args)

    # Derived (reference arguments.py:393-396)
    args.do_classifier_free_guidance = args.cfg_scale > 1.0
    if args.reward_weights is None:
        models = args.caption_model if isinstance(args.caption_model, list) \
            else [args.caption_model]
        args.reward_weights = [1.0] * len(models)
    return args
