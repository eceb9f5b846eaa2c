"""The port's metrics: SSIM, LPIPS (AlexNet), and FID / KID / IS over the
FID InceptionV3 (counterparts of ``ladi_vton_tpu/metrics``)."""
