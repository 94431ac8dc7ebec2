#!/bin/bash
# SD1.5 CoMat recipe on NVIDIA cards with the PyTorch port: the flags of
# the repo's scripts/sd15.sh (the reference's training run, Grounded-SAM
# masks included), passed to comat_tpu_torch.train under torchrun, one
# process a card: NPROC_PER_NODE=8 is the reference's node8.yaml (global
# batch 8 x 4), the default 1 one card. Until the
# SD1.5 and BLIP snapshots can be loaded, it adds --allow_smoke (seeded
# weights, hash tokenizers). Grounded-SAM's weights load with
# --fastsam_checkpoint FastSAM-x.pt --gdino_checkpoint
# groundingdino_swint_ogc.pth --gdino_tokenizer_vocab vocab.txt, else they
# are seeded. Extra flags follow, e.g. --max_train_steps 3.
torchrun --standalone --nproc_per_node "${NPROC_PER_NODE:-1}" -m comat_tpu_torch.train \
  --pretrain_model_name sd_1_5_attrcon \
  --pretrain_model "${PRETRAIN_MODEL:-runwayml/stable-diffusion-v1-5}" \
  --training_prompts "${TRAINING_PROMPTS:-collected_data/abc5k.txt}" \
  --output_dir "${OUTPUT_DIR:-output/sd15_comat}" \
  --resolution 512 \
  --train_batch_size 4 \
  --gradient_accumulation_steps 1 \
  --max_train_steps 2000 \
  --learning_rate 5e-5 --max_grad_norm 0.1 \
  --lr_scheduler constant --lr_warmup_steps 0 \
  --caption_model Blip \
  --gradient_checkpointing \
  --seed 42 \
  --K 5 --total_step 50 --scheduler DDPM --cfg_scale 7.5 \
  --lora_rank 128 \
  --gan_loss --gan_loss_weight 1 \
  --learning_rate_D 2e-5 --adam_beta1_D 0 --max_grad_norm_D 1 \
  --gan_model_arch gansd_1_5 \
  --gan_gt_path "${GAN_GT_PATH:-}" \
  --seg_model gsam \
  --attrcon_train_steps 2 \
  --mask_token_loss_weight 1e-3 --mask_pixel_loss_weight 5e-5 \
  --validation_prompts "A man walking on street" \
  --validation_steps 200 \
  --allow_smoke \
  "$@"
