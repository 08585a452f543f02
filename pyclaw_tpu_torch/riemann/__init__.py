"""Riemann solver library, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/__init__.py``.  Every solver is a
plain function on whole interface tensors, registered in a
:class:`RiemannSolver` record that also carries ``num_eqn`` /
``num_waves`` metadata.  The port has all 35 records of the JAX package,
each with the hooks the JAX record sets: the 1D solvers (advection,
acoustics, Euler, shallow water, the p-system, variable-coefficient
advection and acoustics, Burgers, traffic, MHD), the AoS and SoA hooks
of the 2D Euler Roe solvers (``euler_4wave_2D``, ``euler_5wave_2D`` with
its passive tracer) and of ``acoustics_2D``, the AoS hooks of the other
2D solvers (shallow water, the scalar and variable-coefficient solvers,
the rpt-less ``psystem_2D`` and ``shallow_sphere_fwave_2D``) and of the
3D solvers (``euler_3D``, ``advection_3D``, ``acoustics_3D``,
``vc_acoustics_3D``, ``burgers_3D``), and the ``flux``, ``positivity``
and ``evec`` (char_decomp) hooks.

AoS calling conventions (classic/kernels.py), q (num_eqn, *n):

  rp(ixy, q_l, q_r, aux_l, aux_r, params) -> (wave, s, amdq, apdq)
      wave (num_eqn, num_waves, *n), s (num_waves, *n)
  rpt(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params, trans_axis, eig)
      -> (bm, bp), the split of asdq along spatial axis trans_axis
  rptt(ixy, icoor, imp, impt, q_l, q_r, aux_l, aux_r, bsasdq, params,
       trans_axis, eig) -> (cm, cp)
  prefactor(ixy, q_l, q_r, aux_l, aux_r, params) -> eig

SoA calling conventions (classic/soa.py):

  rpn_soa(ixy, qs_l, qs_r, params) -> (waves, speeds)
      waves: tuple over waves p of tuples over equations e of 2D tensors
             (None for identically-zero components); speeds: tuple over p
  rpt_soa(ixy, imp, qs_l, qs_r, asdq, params, eig=None) -> (bm, bp)
  prefactor_soa(ixy, qs_l, qs_r, params) -> eig (the shared Roe averages)

``ixy`` is a Python int (0 = x sweep, 1 = y sweep); ``params`` is the
problem_data dict of physics scalars.
"""

from __future__ import annotations


class RiemannSolver:
    """Metadata record for one Riemann solver (the full record of the
    JAX package: every hook field, None where this slice has no port)."""

    def __init__(self, name, num_dim, num_eqn, num_waves, rp,
                 rpt=None, rptt=None, requires=()):
        self.name = name
        self.num_dim = num_dim
        self.num_eqn = num_eqn
        self.num_waves = num_waves
        self.rp = rp          # normal solver (AoS form)
        self.rpt = rpt        # transverse solver (2D/3D, AoS form)
        self.rptt = rptt      # double-transverse solver (3D)
        # shared-eigensystem hooks: computed once per sweep direction and
        # passed as eig= to every transverse call at those interfaces
        self.prefactor = None
        self.prefactor_soa = None
        self.transverse_batchable = False
        self.evec = None      # eigenvector hook for char_decomp
        # SoA variants (classic/soa.py protocol)
        self.rpn_soa = None
        self.rpt_soa = None
        self.positivity = None
        self.flux = None
        self.flux_soa = None
        self.requires = tuple(requires)  # required problem_data keys

    def __repr__(self):
        return (f"RiemannSolver({self.name}, num_eqn={self.num_eqn}, "
                f"num_waves={self.num_waves})")


from .advection import (  # noqa: E402,F401
    advection_1D, advection_2D, advection_3D, vc_advection_1D,
    vc_advection_2D, vc_advection_fwave_1D, vc_advection_fwave_2D)
from .acoustics import (  # noqa: E402,F401
    acoustics_1D, acoustics_2D, acoustics_3D)
from .acoustics_var import (  # noqa: E402,F401
    acoustics_variable_1D, vc_acoustics_2D, vc_acoustics_3D)
from .burgers import burgers_1D, burgers_2D, burgers_3D  # noqa: E402,F401
from .euler import (  # noqa: E402,F401
    euler_3D, euler_4wave_2D, euler_5wave_2D, euler_hlle_1D, euler_roe_1D,
    euler_with_efix_1D)
from .shallow import (  # noqa: E402,F401
    shallow_bathymetry_fwave_1D, shallow_bathymetry_fwave_2D,
    shallow_hlle_1D, shallow_roe_with_efix_1D, shallow_roe_with_efix_2D,
    sw_aug_1D, sw_aug_2D)
from .traffic import traffic_1D  # noqa: E402,F401
from .kpp import kpp_2D  # noqa: E402,F401
from .psystem import psystem_1D  # noqa: E402,F401
from .psystem2d import psystem_2D  # noqa: E402,F401
from .shallow_sphere import shallow_sphere_fwave_2D  # noqa: E402,F401
from .mhd import mhd_1D  # noqa: E402,F401

ALL = {s.name: s for s in [advection_1D, acoustics_1D, euler_with_efix_1D,
                           euler_roe_1D, euler_hlle_1D, sw_aug_1D,
                           euler_4wave_2D, euler_5wave_2D, acoustics_2D,
                           euler_3D, shallow_roe_with_efix_2D,
                           shallow_bathymetry_fwave_2D, sw_aug_2D,
                           advection_3D,
                           acoustics_3D, vc_acoustics_3D, advection_2D,
                           vc_advection_2D, vc_advection_fwave_2D,
                           vc_acoustics_2D, kpp_2D, burgers_2D,
                           burgers_3D, psystem_2D, shallow_sphere_fwave_2D,
                           shallow_roe_with_efix_1D, shallow_hlle_1D,
                           shallow_bathymetry_fwave_1D, psystem_1D,
                           vc_advection_1D, vc_advection_fwave_1D,
                           acoustics_variable_1D, burgers_1D, traffic_1D,
                           mhd_1D]}
