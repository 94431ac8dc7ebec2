"""Training entry point of the PyTorch port, the counterpart of
training_script.py: parse the reference's flags, join the process group
`torchrun` describes (if any), build the `Trainer`, train. Runs on CUDA
unless `--device cpu`; without a card it raises.

    python -m comat_tpu_torch.train --training_prompts prompts.txt \\
        --tiny_models --device cpu --max_train_steps 3 --output_dir out

On N cards of one machine, one process a card (--train_batch_size is per
card, so the global batch is N times it):

    torchrun --standalone --nproc_per_node N -m comat_tpu_torch.train ...

The SD1.5 recipe: comat_tpu_torch/scripts/sd15.sh (NPROC_PER_NODE=8 is
the reference's node8.yaml). Checkpoints land in
`<output_dir>/checkpoint-{step}/` (state.pt, metadata.json and the LoRA
export pytorch_lora_weights.safetensors), metrics in
`<output_dir>/metrics.jsonl`, validation images in
`<output_dir>/validation_images/`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch.distributed as dist

from comat_tpu_torch.parallel.mesh import init_distributed
from comat_tpu_torch.training.arguments import parse_args
from comat_tpu_torch.training.trainer import Trainer


def main(argv=None, probe: Optional[Callable[[], Dict[str, int]]] = None) -> Trainer:
    """Train with the flags `argv` (sys.argv when None); returns the
    trainer. `probe`: see `Trainer`. The process group is joined before
    anything touches CUDA (parsing the flags does not), and the group this
    call made is destroyed at the end; a caller's own group is kept."""
    args = parse_args(argv)
    joined = init_distributed(device=args.device)
    try:
        trainer = Trainer(args, probe=probe)
        trainer.train()
        trainer.metrics.close()
    finally:
        if joined:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
