from .device import resolve_device
from .device_guard import acquire_device, guard_device_acquisition

__all__ = ["acquire_device", "guard_device_acquisition", "resolve_device"]
