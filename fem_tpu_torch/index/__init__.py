from fem_tpu_torch.index.build import build_index, hash_windows
from fem_tpu_torch.index.storage import FemIndex, load_index, save_index

__all__ = ["FemIndex", "build_index", "hash_windows", "load_index", "save_index"]
