"""Functional layers (eval mode) over parameter dicts."""

from hitadv_torch.nn import functional  # noqa: F401
