// A block on the host: its threads are coroutines that run one
// scalar thread program, each warp's 32 in lockstep. A thread that reaches
// a warp-wide operation hands its value to gather() and yields; a thread
// that reaches barrier() counts itself in and yields until every thread of
// the block has. The scheduler resumes the threads round-robin, one step
// each a round, so the 32 threads of a warp are always at the same point:
// when a thread runs again after gather(), every thread of its warp has
// handed in its value for that operation. Two alternating value rows a
// warp let the fastest thread start the next operation while the others
// still read the last one. A coroutine starts on its own stack through
// ucontext and from then on switches by _setjmp/_longjmp, which save no
// signal mask and so make no system call.
#pragma once

#include <setjmp.h>
#include <stdint.h>
#include <ucontext.h>

#include <functional>
#include <vector>

namespace warp_emul {

struct Thread {
  ucontext_t start;
  jmp_buf at;
  bool started = false;
};

struct Block {
  jmp_buf scheduler;
  std::vector<Thread> threads;
  std::vector<uint64_t> values;  // [warp][row][lane]
  std::vector<int> phase;
  std::vector<bool> done;
  std::vector<int64_t> passed;  // barriers each thread has gone through
  int64_t arrived = 0;          // barrier arrivals of all threads, ever
  int n = 0;
  int current = 0;
  const std::function<void(int)>* body = nullptr;
};

inline Block*& active() {
  static thread_local Block* b = nullptr;
  return b;
}

// Hands the processor back to the scheduler; returns when it resumes t.
inline void yield(Block* b, int t) {
  if (!_setjmp(b->threads[t].at)) _longjmp(b->scheduler, 1);
}

inline void trampoline() {
  Block* b = active();
  int t = b->current;
  (*b->body)(t);
  b->done[t] = true;
  _longjmp(b->scheduler, 1);
}

const uint64_t* gather(uint64_t mine) {
  Block* b = active();
  int t = b->current;
  int ph = b->phase[t];
  b->phase[t] ^= 1;
  uint64_t* row = &b->values[((t >> 5) * 2 + ph) * 32];
  row[t & 31] = mine;
  yield(b, t);
  return row;
}

int lane() { return active()->current & 31; }

void barrier() {
  Block* b = active();
  int t = b->current;
  int64_t target = int64_t(b->n) * ++b->passed[t];
  ++b->arrived;
  do yield(b, t);
  while (b->arrived < target);
}

// Runs body(t) for threads 0..n-1 (n a multiple of 32) as one block. Every
// thread of a warp must make the same sequence of gather() and barrier()
// calls, and every thread of the block the same barrier() calls, as on the
// card every thread of a warp must reach the same *_sync calls and every
// thread of a block the same __syncthreads.
inline void run_block(int n, const std::function<void(int)>& body) {
  constexpr size_t kStack = 64 * 1024;
  static thread_local std::vector<char> stacks;
  if (stacks.size() < n * kStack) stacks.resize(n * kStack);
  Block b;
  b.n = n;
  b.body = &body;
  b.threads.resize(n);
  b.values.assign(size_t(n) * 2, 0);
  b.phase.assign(n, 0);
  b.done.assign(n, false);
  b.passed.assign(n, 0);
  Block* outer = active();
  active() = &b;
  for (int t = 0; t < n; ++t) {
    ucontext_t& c = b.threads[t].start;
    getcontext(&c);
    c.uc_stack.ss_sp = stacks.data() + t * kStack;
    c.uc_stack.ss_size = kStack;
    c.uc_link = nullptr;  // a thread ends by jumping back to the scheduler
    makecontext(&c, trampoline, 0);
  }
  for (volatile bool any = true; any;) {
    any = false;
    for (volatile int t = 0; t < n; ++t) {
      if (b.done[t]) continue;
      b.current = t;
      any = true;
      if (!_setjmp(b.scheduler)) {
        Thread& th = b.threads[t];
        if (th.started) _longjmp(th.at, 1);
        th.started = true;
        ucontext_t from;
        swapcontext(&from, &th.start);
      }
    }
  }
  active() = outer;
}

// One warp: a block of 32 threads.
inline void run_warp(const std::function<void(int)>& body) { run_block(32, body); }

}  // namespace warp_emul
