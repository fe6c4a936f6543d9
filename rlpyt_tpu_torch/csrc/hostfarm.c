/* hostfarm.c — futex-based shared-memory step barrier for the host env
 * farm (rlpyt_tpu_torch/envs/host.py:SharedMemVecEnv;
 * a copy of csrc/hostfarm.c, the JAX package's).
 *
 * Replaces per-worker multiprocessing.Event pairs (2·W Python-level
 * syscall round-trips per env step, each ~10-100 µs) with one C call per
 * side per step over a process-shared control block:
 *
 *   layout (uint32 slots, 64-byte cache-line strides):
 *     ctrl[0]          command word (written by master before signal)
 *     ctrl[16]         master sequence counter (signal = increment+wake)
 *     ctrl[32 + 16*w]  worker w completion counter (post = set to seq)
 *
 * Workers spin briefly (microsecond-class env steps never sleep) and
 * fall back to FUTEX_WAIT; the master does the same while collecting
 * completions.  Non-PRIVATE futex ops: the block is shared across
 * processes (multiprocessing.RawArray pages).
 *
 * The counterpart of the reference's per-step semaphore pairs in
 * rlpyt/samplers/parallel/gpu/action_server.py (~L30).
 */
#define _GNU_SOURCE
#include <stdint.h>
#include <limits.h>
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define cpu_relax() _mm_pause()
#elif defined(__aarch64__)
#define cpu_relax() __asm__ __volatile__("yield")
#else
#define cpu_relax() ((void)0)
#endif

#define SEQ_SLOT 16
#define DONE_SLOT(w) (32 + 16 * (w))

static long futex(volatile uint32_t *addr, int op, uint32_t val) {
    return syscall(SYS_futex, addr, op, val, NULL, NULL, 0);
}

/* Master: publish cmd, advance the sequence, wake all workers. */
void hf_master_signal(volatile uint32_t *ctrl, uint32_t cmd) {
    ctrl[0] = cmd;
    __atomic_add_fetch(&ctrl[SEQ_SLOT], 1, __ATOMIC_RELEASE);
    futex(&ctrl[SEQ_SLOT], FUTEX_WAKE, INT_MAX);
}

/* Master: wait until every worker has posted the given sequence. */
void hf_master_wait(volatile uint32_t *ctrl, int n_workers, uint32_t seq,
                    int spin) {
    for (int w = 0; w < n_workers; ++w) {
        volatile uint32_t *d = &ctrl[DONE_SLOT(w)];
        int s = spin;
        uint32_t v;
        while ((v = __atomic_load_n(d, __ATOMIC_ACQUIRE)) != seq) {
            if (s-- > 0) { cpu_relax(); continue; }
            futex(d, FUTEX_WAIT, v); /* spurious wake ok: loop re-checks */
        }
    }
}

/* Worker: block until the sequence advances past last_seq; returns the
 * new sequence (the command is read from ctrl[0] afterwards). */
uint32_t hf_worker_wait(volatile uint32_t *ctrl, uint32_t last_seq,
                        int spin) {
    volatile uint32_t *s = &ctrl[SEQ_SLOT];
    int k = spin;
    uint32_t v;
    while ((v = __atomic_load_n(s, __ATOMIC_ACQUIRE)) == last_seq) {
        if (k-- > 0) { cpu_relax(); continue; }
        futex(s, FUTEX_WAIT, v);
    }
    return v;
}

/* Worker: post completion of the given sequence and wake the master. */
void hf_worker_post(volatile uint32_t *ctrl, int w, uint32_t seq) {
    volatile uint32_t *d = &ctrl[DONE_SLOT(w)];
    __atomic_store_n(d, seq, __ATOMIC_RELEASE);
    futex(d, FUTEX_WAKE, 1);
}

/* Read the current command word (after hf_worker_wait returns). */
uint32_t hf_read_cmd(volatile uint32_t *ctrl) {
    return __atomic_load_n(&ctrl[0], __ATOMIC_ACQUIRE);
}
