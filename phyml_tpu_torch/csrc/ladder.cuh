// The state-count ladder: every kernel is instantiated once per rung, and
// the launch wrappers pad a problem's state count up to the next rung
// (ops/_build.py reads this table, so it is the one list of rungs and
// tiles).  A padded state has a zero row and column in every P-matrix, a
// zero in pi and a zero row and column in V and V^-1, so it never raises
// a column's maximum and adds nothing at the root; the kernels do not
// know it is there.
//
// Columns: NS | K1/K4 rows R, columns Q | K3 R, Q | K2/K5 R, Q.  Each
// lane holds R states x Q patterns of a pattern column split over
// G = NS / R adjacent lanes (G divides 32; NS % 4 == 0, since
// tile_matmul reads P-matrix rows in 16-byte pieces), so a warp covers
// 32 / G * Q patterns.  4, 12 and 20 are exact: DNA, DNA covarion with
// three hidden classes, amino acids.
//
// The top rung is 32: from 33 states on, the big bodies (big.cuh,
// big_ffma.cuh; ns padded to a multiple of 16) were faster than the
// rungs of 40, 48, 60 and 64 states, whose K1/K4 and K3 had to walk the
// rate classes in one warp a block, for every kernel but K3 at B = 2
// and 40 states (PERF.md).
#pragma once

#define PHYML_LADDER(X)             \
  X(4, 4, 1, 4, 2, 4, 1)            \
  X(8, 4, 2, 4, 2, 4, 2)            \
  X(12, 3, 4, 3, 4, 3, 2)           \
  X(16, 4, 4, 4, 4, 4, 2)           \
  X(20, 5, 4, 5, 4, 5, 2)           \
  X(24, 6, 4, 6, 4, 3, 4)           \
  X(32, 4, 4, 4, 4, 4, 2)

namespace phyml {

template <int NS>
struct Rung;  // defined for the rungs only

#define PHYML_RUNG_TRAITS(NS_, SR, SQ, BR, BQ, ER, EQ)                    \
  template <>                                                            \
  struct Rung<NS_> {                                                     \
    static constexpr int kSlotRows = SR, kSlotCols = SQ;                 \
    static constexpr int kBatchRows = BR, kBatchCols = BQ;               \
    static constexpr int kEdotpRows = ER, kEdotpCols = EQ;               \
    static_assert(NS_ % 4 == 0, "P-matrix rows are read in 16 bytes");   \
    static_assert(32 % (NS_ / SR) == 0 && 32 % (NS_ / BR) == 0 &&        \
                      32 % (NS_ / ER) == 0,                              \
                  "a pattern column splits over a power-of-two lanes");  \
  };
PHYML_LADDER(PHYML_RUNG_TRAITS)
#undef PHYML_RUNG_TRAITS

}  // namespace phyml
