// The pair epsilon of the GB kernels (r = sqrt(r^2 + kEps)). The IEEE forms
// of the HCT descreening term and the GBn2 neck correction are the plain
// versions' (md/pair_force.py _hct, md/gbn2.py, md/analytic.py
// born_radii_and_chain), which fused_md.cu's born_pair_sel and neck_fast and
// gb_force.cuh's hct_value, hct_dr and neck_dr follow with single
// special-function results.
#pragma once

namespace {

constexpr float kEps = 1e-12f;

}  // namespace
