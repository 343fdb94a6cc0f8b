"""Writing the raw dataset layout: dataset.json and the converters of public
datasets (counterpart of anatomask_tpu/dataset_conversion)."""
from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.dataset_conversion.convert_msd import convert_msd_dataset
