from repro_torch.data.synthetic import SyntheticTask, make_batch_fn

__all__ = ["SyntheticTask", "make_batch_fn"]
