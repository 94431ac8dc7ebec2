#!/bin/bash
# SDXL CoMat recipe on NVIDIA cards with the PyTorch port: the flags of
# the repo's scripts/sdxl.sh (the reference's SDXL run: the 512-finetuned
# UNet through --sdxl_unet_path, an SD1.5-architecture discriminator,
# Grounded-SAM masks), passed to comat_tpu_torch.train under torchrun, one
# process a card (NPROC_PER_NODE, default 1; 8 is the reference's
# node8.yaml). Until the SDXL, SD1.5 and BLIP snapshots can be
# loaded, it adds --allow_smoke (seeded weights, hash tokenizers).
# Batch 6 a card at 512^2 as in the reference (80 GB cards). Extra flags follow,
# e.g. --max_train_steps 3.
torchrun --standalone --nproc_per_node "${NPROC_PER_NODE:-1}" -m comat_tpu_torch.train \
  --pretrain_model_name sdxl_attrcon_unet \
  --pretrain_model "${PRETRAIN_MODEL:-stabilityai/stable-diffusion-xl-base-1.0}" \
  --sdxl_unet_path "${SDXL_UNET_PATH:-}" \
  --training_prompts "${TRAINING_PROMPTS:-merged_data/abc5k_hrs10k_t2icompall_20k.txt}" \
  --output_dir "${OUTPUT_DIR:-output/sdxl_comat}" \
  --resolution 512 \
  --train_batch_size "${BATCH_SIZE:-6}" \
  --gradient_accumulation_steps 1 \
  --max_train_steps 2000 \
  --learning_rate 2e-5 --max_grad_norm 0.1 \
  --lr_scheduler constant --lr_warmup_steps 0 \
  --caption_model Blip \
  --gradient_checkpointing \
  --seed 42 \
  --K 5 --total_step 50 --scheduler DDPM --cfg_scale 7.5 \
  --lora_rank 128 \
  --gan_loss --gan_loss_weight 5e-1 \
  --learning_rate_D 5e-5 --adam_beta1_D 0 --max_grad_norm_D 1 \
  --gan_model_arch gansd_1_5 \
  --gan_gt_path "${GAN_GT_PATH:-}" \
  --seg_model gsam \
  --attrcon_train_steps 2 \
  --mask_token_loss_weight 1e-3 --mask_pixel_loss_weight 5e-5 \
  --validation_prompts "A man walking on street" \
  --validation_steps 200 --num_validation_images 0 \
  --allow_smoke \
  "$@"
