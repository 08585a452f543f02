// ctu3d.cuh — the tile geometry shared by the 3D CTU kernels
// (step3_ctu.cu, step3_aos.cu): a block owns a tile of H::X x H::Y x
// H::Z output cells (each kernel sets its threads per block per type); the regions of the sweep along D are
// counted relative to the tile's first interior cell C0.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernels' host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

#define CMAX(a, b) ((a) > (b) ? (a) : (b))

namespace {

// Regions of the sweep along D (extents along x, y, z)
template <class H, int D> struct Reg {
  // normal solves: interfaces C0-2 .. C0+T along D, cells C0-1 .. C0+T
  // across
  static constexpr int A0 = H::X + (D == 0 ? 3 : 2);
  static constexpr int A1 = H::Y + (D == 1 ? 3 : 2);
  static constexpr int A2 = H::Z + (D == 2 ? 3 : 2);
  static constexpr int AN = A0 * A1 * A2;
  // splits: interfaces C0-1 .. C0+T-1 along D, cells C0-1 .. C0+T across
  static constexpr int B0 = H::X + (D == 0 ? 1 : 2);
  static constexpr int B1 = H::Y + (D == 1 ? 1 : 2);
  static constexpr int B2 = H::Z + (D == 2 ? 1 : 2);
  static constexpr int BN = B0 * B1 * B2;
  // faces of the D-flux: interfaces C0-1 .. C0+T-1 along D, tile cells
  static constexpr int F0 = H::X + (D == 0 ? 1 : 0);
  static constexpr int F1 = H::Y + (D == 1 ? 1 : 0);
  static constexpr int F2 = H::Z + (D == 2 ? 1 : 0);
  static constexpr int FN = F0 * F1 * F2;
};

template <int E0, int E1, int E2> HD void dec(int idx, int c[3]) {
  c[0] = idx / (E1 * E2);
  c[1] = (idx / E2) % E1;
  c[2] = idx % E2;
}

template <int E0, int E1, int E2> HD int flat(const int c[3]) {
  return (c[0] * E1 + c[1]) * E2 + c[2];
}

// tiles along x, y, z of a padded (2 ghost cells) grid: ragged edges
// round up (host code: the launch sizes its grid with it)
template <class H> inline void tile_counts(const int N[3], int nb[3]) {
  nb[0] = (N[0] - 4 + H::X - 1) / H::X;
  nb[1] = (N[1] - 4 + H::Y - 1) / H::Y;
  nb[2] = (N[2] - 4 + H::Z - 1) / H::Z;
}

// first interior cell C0 (padded indices) of block b's tile
template <class H> HD void tile_origin(const int nb[3], int b, int C0[3]) {
  C0[2] = 2 + (b % nb[2]) * H::Z;
  C0[1] = 2 + ((b / nb[2]) % nb[1]) * H::Y;
  C0[0] = 2 + (b / (nb[2] * nb[1])) * H::X;
}

}  // namespace
