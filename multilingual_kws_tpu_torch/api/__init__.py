"""The command line: ``python -m multilingual_kws_tpu_torch.api.cli``."""
