from navierstokes_tpu_torch.utils.profiling import EventLog

__all__ = ["EventLog"]
