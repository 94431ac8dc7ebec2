"""Alignment evaluation for the PyTorch port: generate, then score.

Port of comat_tpu/tools/evaluate.py, the same flags (and the generator's
--cache-dir and --device), per-prompt JSON rows and summary line. Two
metrics (--metric, default both):

  blip_reward: the frozen BLIP captioner's reward of each generated image
    for its prompt (the signal CoMat trains on, measured out of sample),
    per image as JAX takes it by `vmap` of the scalar reward, the captions
    padded or cut to 48 tokens.
  bvqa_binding: the T2I-CompBench attribute-binding pattern, the paper's
    metric. Each prompt's attribute-noun groups (`text.linguistics.
    extract_attribute_groups`, the attribute-concentration extraction), at
    most --max-questions, become yes/no questions "<attributes> <noun>?"
    (the prompt itself when it has none); BLIP-VQA (`models/blip_vqa.py`,
    ViT-B `BLIPConfig.base()`) gives P(yes) for each, and the binding
    score is their product (their mean is recorded too).

Rows: {"prompt", "blip_reward", "bvqa_binding", "bvqa_questions",
"bvqa_p_yes", "bvqa_mean_p_yes"}; summary: {"n", "mean_blip_reward",
"mean_bvqa_binding"}. `main` returns them with the seconds of generation,
decode, reward and bvqa apart.

Gates (failure is loud): a full-size bvqa run without --vqa-model-path (a
Salesforce/blip-vqa-base snapshot) prints a SKIPPED line and scores none
unless --allow-smoke (seeded VQA weights, meaningless numbers); real VQA
weights without --vqa-tokenizer-vocab exit. JAX scores blip_reward with a
seeded captioner and a hash tokenizer and has no flag for a captioner
snapshot, so a full-size blip_reward is gated the same way. A full-size
run without --pretrain-model (seeded towers) or CLIP tokenizer files
refuses unless --allow-smoke. --tiny runs everything seeded. The towers
and --checkpoint load as in `tools/generate.py` (the LoRA's rank read from
the file; JAX hard-codes 32). Generation samples with one LoRA-fused UNet
and decodes each batch (kernels A and B on the card), its initial latents
and per-step noise drawn from a `torch.Generator` seeded by --seed. On
CUDA unless --device cpu. Example:

    python -m comat_tpu_torch.tools.evaluate --prompt-path prompts.txt \\
        --out results.jsonl --pretrain-model runwayml/stable-diffusion-v1-5 \\
        --cache-dir ~/hf --checkpoint out/checkpoint-2000 \\
        --vqa-model-path <blip-vqa-base snapshot> \\
        --vqa-tokenizer-vocab <snapshot>/vocab.txt --metric bvqa_binding
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

CAPTION_LENGTH = 48     # the caption batch's fixed length (JAX's S)
QUESTION_LENGTH, ANSWER_LENGTH = 16, 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="comat_tpu_torch alignment eval")
    p.add_argument("--model", default="sd_1_5")
    p.add_argument("--prompt-path", required=True)
    p.add_argument("--out", default=None, help="jsonl results path")
    p.add_argument("--checkpoint", default=None,
                   help="the trainer's checkpoint-{step} folder or a "
                        "pytorch_lora_weights.safetensors")
    p.add_argument("--pretrain-model", default=None,
                   help="diffusers snapshot folder, or a repo id under --cache-dir")
    p.add_argument("--cache-dir", default=None, help="HF hub cache root")
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-prompts", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--metric", default="both",
                   choices=("blip_reward", "bvqa_binding", "both"))
    p.add_argument("--vqa-model-path", default=None,
                   help="Salesforce/blip-vqa-base snapshot dir (safetensors) for "
                        "the binding scorer")
    p.add_argument("--vqa-tokenizer-vocab", default=None,
                   help="bert vocab.txt for the VQA question tokenizer")
    p.add_argument("--allow-smoke", action="store_true",
                   help="permit seeded weights and hash tokenizers at full size "
                        "(plumbing smoke only; numbers meaningless)")
    p.add_argument("--max-questions", type=int, default=4,
                   help="attribute groups scored per prompt")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_bvqa_scorer(args, blip_cfg, device="cuda"):
    """score(images (N, H, W, 3) in [0, 1], prompts) -> one dict per prompt,
    or None after printing the skip line (JAX's `make_bvqa_scorer`)."""
    import numpy as np
    import torch

    from comat_tpu_torch.losses.caption_reward import blip_preprocess
    from comat_tpu_torch.models.blip_vqa import build_answer_batch, encode_fixed, make_blip_vqa
    from comat_tpu_torch.text.linguistics import extract_attribute_groups
    from comat_tpu_torch.text.tokenizer import (
        BertWordPieceTokenizer, HashTokenizer, load_clip_tokenizer,
    )

    if not args.tiny and not args.vqa_model_path:
        if not args.allow_smoke:
            print(json.dumps({
                "bvqa_binding": "SKIPPED",
                "reason": "no --vqa-model-path (Salesforce/blip-vqa-base snapshot) and "
                          "not --allow-smoke: random-weight VQA scores are meaningless"}))
            return None
        print(json.dumps({"bvqa_binding_warning": "--allow-smoke: random VQA weights"}))
    if args.vqa_tokenizer_vocab and os.path.isfile(args.vqa_tokenizer_vocab):
        q_tok = BertWordPieceTokenizer(args.vqa_tokenizer_vocab)
    elif args.vqa_model_path:
        # real weights and hash ids would score confidently wrong numbers
        raise SystemExit(
            "--vqa-model-path given but --vqa-tokenizer-vocab is missing or not a file "
            f"({args.vqa_tokenizer_vocab!r}); real BLIP-VQA weights need the real "
            "WordPiece vocab (vocab.txt from the same snapshot).")
    else:
        q_tok = HashTokenizer(blip_cfg.vocab_size)
    vqa = make_blip_vqa(blip_cfg, device, seed=args.seed + 11)
    if args.vqa_model_path:
        from comat_tpu_torch.models.hf_import import load_blip_vqa_state

        report = load_blip_vqa_state(args.vqa_model_path, vqa)
        if report.missing:
            raise ValueError(f"{args.vqa_model_path} lacks {len(report.missing)} BLIP-VQA "
                             f"tensors (first: {report.missing[:5]})")
    # the CLIP tokenizer only places the groups' token indices
    g_tok = HashTokenizer(49408) if args.tiny else load_clip_tokenizer(args.tokenizer_dir)
    H, W = blip_cfg.image_size, args.max_questions

    def ids(a):
        return torch.from_numpy(a).to(next(vqa.parameters()).device)

    answers = [ids(a) for ans in ("yes", "no") for a in build_answer_batch(
        q_tok, [ans], 1, ANSWER_LENGTH, bos_token_id=blip_cfg.bos_token_id)]

    @torch.no_grad()
    def score(images, prompts) -> List[Dict[str, object]]:
        out = []
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        for img, prompt in zip(images.float(), prompts):
            groups = extract_attribute_groups(prompt, g_tok)[:W]
            questions = [" ".join(g.attribute_words + [g.noun]) + "?" for g in groups] \
                or [prompt + "?"]        # no groups: the whole prompt (T2I style)
            q_ids, q_mask = (ids(a) for a in encode_fixed(q_tok, questions, QUESTION_LENGTH))
            n = len(questions)
            pix = blip_preprocess(img[None].to(q_ids.device), size=H).expand(n, H, H, 3)
            probs = vqa.yes_probability(pix, q_ids, q_mask,
                                        *(a.expand(n, ANSWER_LENGTH) for a in answers))
            probs = probs.float().cpu().numpy()
            out.append({
                "bvqa_questions": questions,
                "bvqa_p_yes": [round(float(x), 6) for x in probs],
                "bvqa_binding": float(np.prod(probs)),
                "bvqa_mean_p_yes": float(np.mean(probs)),
            })
        return out

    return score


def main(argv=None) -> Dict[str, object]:
    """Print (and with --out write) the rows and the summary; returns
    {"rows", "summary", "seconds": {"generate", "decode", "reward",
    "bvqa"}} (wall seconds, synchronised)."""
    args = parse_args(argv)
    from comat_tpu_torch.config import BLIPConfig

    reward_on = args.metric in ("blip_reward", "both")
    if reward_on and not args.tiny:
        if not args.allow_smoke:
            print(json.dumps({
                "blip_reward": "SKIPPED",
                "reason": "no captioner snapshot flag (as in JAX) and not --allow-smoke: "
                          "a seeded captioner's rewards are meaningless"}))
            reward_on = False
        else:
            print(json.dumps({"blip_reward_warning": "--allow-smoke: seeded captioner "
                              "weights and a HashTokenizer"}))
    seconds = {"generate": 0.0, "decode": 0.0, "reward": 0.0, "bvqa": 0.0}
    bvqa = None
    if args.metric in ("bvqa_binding", "both"):
        # blip-vqa-base is ViT-B: BLIPConfig.base(), not the captioner's large()
        bcfg = BLIPConfig.tiny() if args.tiny else BLIPConfig.base()
        bvqa = make_bvqa_scorer(args, bcfg, args.device)
    rows: List[Dict[str, object]] = []
    if not (reward_on or bvqa):
        return _finish(args, rows, seconds)

    import numpy as np
    import torch

    from comat_tpu_torch.losses.caption_reward import blip_caption_rewards, build_caption_batch
    from comat_tpu_torch.models.blip import make_blip
    from comat_tpu_torch.text.tokenizer import HashTokenizer
    from comat_tpu_torch.tools.gan_gt_generate import load_sampler, sample_prompts
    from comat_tpu_torch.training.data import load_prompts

    sampler = load_sampler(args, "the images")
    pipe = sampler.pipe
    blip = blip_tok = None
    if reward_on:
        blip_cfg = BLIPConfig.tiny() if args.tiny else BLIPConfig.large()
        blip = make_blip(blip_cfg, pipe.device, seed=args.seed + 1)
        blip_tok = HashTokenizer(blip_cfg.vocab_size)

    prompts = load_prompts(args.prompt_path, args.max_prompts)
    B, S = args.batch_size, CAPTION_LENGTH

    def pad(a, v):
        return np.pad(a, ((0, 0), (0, max(S - a.shape[1], 0))), constant_values=v)[:, :S]

    def clock(name, t0):
        _sync(pipe.device)
        seconds[name] += time.perf_counter() - t0
        return time.perf_counter()

    for i in range(0, len(prompts), B):
        chunk = prompts[i:i + B]
        padded = chunk + [""] * (B - len(chunk))
        t0 = time.perf_counter()
        latents = sample_prompts(sampler, padded, args.num_inference_steps,
                                 args.guidance_scale)
        t0 = clock("generate", t0)
        with torch.no_grad():
            images = pipe.decode_image(latents).clamp(0.0, 1.0).float()
        t0 = clock("decode", t0)
        r = None
        if reward_on:
            cap = build_caption_batch(blip_tok, padded)
            with torch.no_grad():
                r = blip_caption_rewards(blip, images, pad(cap["input_ids"], 0),
                                         pad(cap["attention_mask"], 0),
                                         pad(cap["labels"], -100)).float().cpu().numpy()
            t0 = clock("reward", t0)
        bvqa_rows = bvqa(images[:len(chunk)], chunk) if bvqa else None
        clock("bvqa", t0)
        for j, p in enumerate(chunk):
            rec: Dict[str, object] = {"prompt": p}
            if r is not None:
                rec["blip_reward"] = float(r[j])
            if bvqa_rows:
                rec.update(bvqa_rows[j])
            rows.append(rec)
            print(json.dumps(rec))
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f" on {pipe.device}")
    return _finish(args, rows, seconds)


def _finish(args, rows, seconds) -> Dict[str, object]:
    """The summary line; rows and summary to --out."""
    import numpy as np

    rewards = [r["blip_reward"] for r in rows if "blip_reward" in r]
    bindings = [r["bvqa_binding"] for r in rows if "bvqa_binding" in r]
    summary: Dict[str, object] = {"n": max(len(rewards), len(bindings))}
    if rewards:
        summary["mean_blip_reward"] = float(np.mean(rewards))
    if bindings:
        summary["mean_bvqa_binding"] = float(np.mean(bindings))
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for rec in rows + [summary]:
                f.write(json.dumps(rec) + "\n")
    return {"rows": rows, "summary": summary, "seconds": seconds}


if __name__ == "__main__":
    main()
