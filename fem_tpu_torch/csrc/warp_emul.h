// A warp on the host: 32 coroutines (ucontext) run one scalar lane program
// in lockstep. A lane that reaches a warp-wide operation hands its value to
// gather() and yields; the scheduler resumes the lanes round-robin, so when
// a lane runs again every lane has handed in its value for that operation.
// Two alternating value rows let the fastest lane start the next operation
// while the others still read the last one.
#pragma once

#include <stdint.h>
#include <ucontext.h>

#include <functional>
#include <vector>

namespace warp_emul {

struct Warp {
  ucontext_t scheduler;
  ucontext_t lanes[32];
  uint64_t values[2][32];
  int phase[32];
  bool done[32];
  int current = 0;
  const std::function<void(int)>* body = nullptr;
};

inline Warp*& active() {
  static thread_local Warp* w = nullptr;
  return w;
}

inline void trampoline() {
  Warp* w = active();
  int lane = w->current;
  (*w->body)(lane);
  w->done[lane] = true;
  swapcontext(&w->lanes[lane], &w->scheduler);
}

const uint64_t* gather(uint64_t mine) {
  Warp* w = active();
  int lane = w->current;
  int ph = w->phase[lane];
  w->phase[lane] ^= 1;
  w->values[ph][lane] = mine;
  swapcontext(&w->lanes[lane], &w->scheduler);
  return w->values[ph];
}

int lane() { return active()->current; }

// Runs body(lane) for lanes 0..31 as one warp. Every lane must make the
// same sequence of gather() calls, as every thread of a warp on the card
// must reach the same *_sync calls.
inline void run_warp(const std::function<void(int)>& body) {
  constexpr size_t kStack = 64 * 1024;
  static thread_local std::vector<char> stacks(32 * kStack);
  Warp w;
  w.body = &body;
  Warp* outer = active();
  active() = &w;
  for (int l = 0; l < 32; ++l) {
    w.phase[l] = 0;
    w.done[l] = false;
    getcontext(&w.lanes[l]);
    w.lanes[l].uc_stack.ss_sp = stacks.data() + l * kStack;
    w.lanes[l].uc_stack.ss_size = kStack;
    w.lanes[l].uc_link = &w.scheduler;
    makecontext(&w.lanes[l], trampoline, 0);
  }
  for (bool any = true; any;) {
    any = false;
    for (int l = 0; l < 32; ++l) {
      if (w.done[l]) continue;
      w.current = l;
      swapcontext(&w.scheduler, &w.lanes[l]);
      any = true;
    }
  }
  active() = outer;
}

}  // namespace warp_emul
