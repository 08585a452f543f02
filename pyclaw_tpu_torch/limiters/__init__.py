"""Wave limiters (counterpart of ``pyclaw_tpu/limiters``).  This slice
ports the TVD family; the WENO reconstructions come with SharpClaw."""

from . import tvd  # noqa: F401
