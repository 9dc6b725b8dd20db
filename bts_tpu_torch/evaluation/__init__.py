from bts_tpu_torch.evaluation.metrics import METRIC_NAMES, compute_errors, compute_errors_torch  # noqa: F401
