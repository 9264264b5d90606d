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
// 32 / G * Q patterns.  4, 12, 20 and 60 are exact: DNA, DNA covarion
// with three hidden classes, amino acids, amino-acid covarion with
// three.  At 60 a column splits over at most 4 lanes (60 = 4 x 15), so
// a lane holds 15 states.
//
// Rungs from kWideNS up ("wide") run K1, K4 and K3 as one warp a block
// that walks the rate classes in turn, reusing one share of shared
// memory (a block of C class warps would need 346 KB for K4 and 230 KB
// of P-matrix ring for K3 at ns = 60, C = 4), with K1/K4's ring one step
// ahead instead of two.  K2/K5 run one warp a block at every rung; their
// shared memory is dynamic, since above ~32 states it passes the 48 KB
// a block may hold statically.
#pragma once

#define PHYML_LADDER(X)             \
  X(4, 4, 1, 4, 2, 4, 1)            \
  X(8, 4, 2, 4, 2, 4, 2)            \
  X(12, 3, 4, 3, 4, 3, 2)           \
  X(16, 4, 4, 4, 4, 4, 2)           \
  X(20, 5, 4, 5, 4, 5, 2)           \
  X(24, 6, 4, 6, 4, 3, 4)           \
  X(32, 4, 4, 4, 4, 4, 2)           \
  X(40, 5, 4, 5, 4, 5, 2)           \
  X(48, 6, 4, 6, 4, 6, 2)           \
  X(60, 15, 2, 15, 2, 15, 1)        \
  X(64, 8, 4, 8, 4, 8, 1)

namespace phyml {

// first wide rung: K1, K4 and K3 walk the classes in one warp
constexpr int kWideNS = 40;

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
