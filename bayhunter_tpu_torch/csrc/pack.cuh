// Row layout of the per-chain RF pack that K1 (prep.cu) writes and K3
// (resp.cu) reads, one (rows, C) plane per named row.
//
// The offsets are not defined here: both wrappers pass them, as this
// struct by value, from bayhunter_tpu_torch/ops/rf.py pack_offsets,
// the one definition of the layout, which the plain twins use too.
// The field order matches ops/_ext.py PackLayout (a test checks it).
#pragma once

struct PackLayout {
    int h;      // NL flattened thicknesses
    int vp;     // NL flattened P velocities
    int vs;     // NL flattened S velocities
    int p;      // slowness (s/km)
    int t0;     // direct-arrival time
    int hmat;   // displacement matrix, 8 rows (re, im of 11, 12, 21, 22)
    int nt;     // free-surface reflection, 8 rows
    int depth;  // skip depth; the last named row
    int rows;   // padded height; rows after depth are zero
};
