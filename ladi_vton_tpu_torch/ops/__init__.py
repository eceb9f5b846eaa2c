from ladi_vton_tpu_torch.ops.morphology import dilate
