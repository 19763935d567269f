"""Shared helpers: parameter declarations and the default device."""
from .params import ParamDecl, default_device, init_params

__all__ = ["ParamDecl", "default_device", "init_params"]
