"""Device core: device ms under the port's ``l1_to_l2.<stage>`` ranges per SCA."""

from gpubench.readers import core_device_ms as read  # noqa: F401
