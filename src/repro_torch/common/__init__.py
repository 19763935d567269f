"""Shared helpers: parameter declarations, the default device and the
runtime guards."""
from .guards import (CompileGuard, device_get, global_compile_count,
                     no_host_sync, record_compile, strict_numerics)
from .params import ParamDecl, default_device, init_params

__all__ = ["CompileGuard", "ParamDecl", "default_device", "device_get",
           "global_compile_count", "init_params", "no_host_sync",
           "record_compile", "strict_numerics"]
