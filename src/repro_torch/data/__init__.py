"""Token streams (port of ``repro.data``): Philox-keyed synthetic and
memory-mapped batches with exact skip-ahead, as int32 tensors."""
from repro_torch.data.pipeline import SyntheticLMDataset, TokenFileDataset, make_labels

__all__ = ["SyntheticLMDataset", "TokenFileDataset", "make_labels"]
