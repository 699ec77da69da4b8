from navierstokes_tpu_torch.utils.profiling import EventLog, trace

__all__ = ["EventLog", "trace"]
