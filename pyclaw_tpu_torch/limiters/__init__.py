"""Wave limiters and reconstructions (counterpart of
``pyclaw_tpu/limiters``): the TVD family and WENO5."""

from . import recon, tvd  # noqa: F401
