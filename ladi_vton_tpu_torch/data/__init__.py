"""The port's data layer: the DressCode and VITON-HD datasets, their
batch loader, and the image I/O and resampling that stand in for PIL."""

from ladi_vton_tpu_torch.data.dresscode import DressCodeDataset
from ladi_vton_tpu_torch.data.loader import BatchLoader
from ladi_vton_tpu_torch.data.vitonhd import VitonHDDataset
