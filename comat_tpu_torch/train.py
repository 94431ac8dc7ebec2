"""Training entry point of the PyTorch port, the counterpart of
training_script.py: parse the reference's flags, build the `Trainer`,
train. Runs on CUDA unless `--device cpu`; without a card it raises.

    python -m comat_tpu_torch.train --training_prompts prompts.txt \\
        --tiny_models --device cpu --max_train_steps 3 --output_dir out

The SD1.5 recipe: comat_tpu_torch/scripts/sd15.sh. Checkpoints land in
`<output_dir>/checkpoint-{step}/` (state.pt, metadata.json and the LoRA
export pytorch_lora_weights.safetensors), metrics in
`<output_dir>/metrics.jsonl`, validation images in
`<output_dir>/validation_images/`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from comat_tpu_torch.training.arguments import parse_args
from comat_tpu_torch.training.trainer import Trainer


def main(argv=None, probe: Optional[Callable[[], Dict[str, int]]] = None) -> Trainer:
    """Train with the flags `argv` (sys.argv when None); returns the
    trainer. `probe`: see `Trainer`."""
    trainer = Trainer(parse_args(argv), probe=probe)
    trainer.train()
    trainer.metrics.close()
    return trainer


if __name__ == "__main__":
    main()
