// One bit-parallel Myers step on u32 lanes, shared by csrc/myers.cu
// (the query is the pattern, a term byte the text) and
// csrc/myers_rev.cu (the term is the pattern, a query byte the text):
// the recurrence of the reference's pallas/fuzzy.py:_myers_tile.
//
//   eq        bitmask of pattern positions equal to the text byte
//   mask      the pattern's low bits (all ones at length >= 32)
//   high_bit  the bit of the pattern's last position
//   pv, mv    the vertical deltas, updated in place
//   score     the distance at the pattern's end, updated in place
//
// chip_smoke.py compiles this step alone for sm_90a and counts its SASS
// instructions: that count is the operations per step of the Myers
// kernels' bound.
#pragma once

#include <stdint.h>

static __device__ __forceinline__ void myers_step(uint32_t eq, uint32_t mask,
                                                  uint32_t high_bit,
                                                  uint32_t& pv, uint32_t& mv,
                                                  int& score) {
  const uint32_t xv = eq | mv;
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  score += (int)((ph & high_bit) != 0) - (int)((mh & high_bit) != 0);
  ph = (ph << 1) | 1u;
  mh = mh << 1;
  pv = (mh | ~(xv | ph)) & mask;
  mv = (ph & xv) & mask;
}
