from repro_torch.data.pipeline import SyntheticLMDataset, DataCursor

__all__ = ["SyntheticLMDataset", "DataCursor"]
