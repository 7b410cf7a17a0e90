"""A numpy rehearsal of csrc/wgmma_s8_gemm.cuh::gemm_block, the block both
int8 kernels run (int8_matmul, int8_conv3x3), for the CPU tests of their
index arithmetic; each kernel's test supplies its A loader.

The rehearsal walks each block as the kernel does: its 256 threads'
cp.async pieces of each K chunk (A: what the kernel's loader gives, zero
where it gives nothing; B: 16 bytes of a row of the (N, K) operand, zero
past N or K) written at `kmajor_offset`; the copies committed in groups and
landing only at the `cp.async.wait_group` that covers them; each of a
chunk's four k32 steps read through its descriptor the way the hardware
forms addresses (rows 128 bytes apart, 8-row groups SBO = 1 KB apart, the
start advanced 32 bytes a step, address bits 4-6 XORed with bits 7-9); one
wgmma group in flight, so each chunk's operands are read both when its
products are issued and when they are retired, with every copy issued by
then landed, and the two reads must agree; the epilogue through the
accumulator fragment layout. Mutations: "swizzle" (rows unswizzled),
"lead" (one chunk more in flight than the ring allows), "steps" (a chunk's
last k32 step left out).
"""

import numpy as np
import torch

BM, BK, THREADS = 128, 128, 256
TID = np.arange(THREADS)
PIECE, ROW0 = TID & 7, TID >> 3     # a thread's piece, and its first row
ZERO = np.zeros(16, np.int8)


def kmajor_offset(row, kbyte):
    """csrc/wgmma_s8.cuh::kmajor_offset."""
    return row * 128 + ((((kbyte >> 4) ^ row) & 7) << 4) + (kbyte & 15)


def descriptor_read(mem, start, rows):
    """What one k32 step of wgmma reads through a K-major 128-byte-swizzle
    descriptor starting at byte `start` (from a 1 KB aligned base): rows x
    32 int8."""
    i = np.arange(rows)[:, None]
    j = np.arange(32)[None, :]
    addr = start + (i // 8) * 1024 + (i % 8) * 128 + j
    return mem[addr ^ (((addr >> 7) & 7) << 4)].astype(np.int64)


class Ring:
    """Shared memory under cp.async: copies land at the wait that covers
    their commit group; `eager()` is the memory with every issued copy
    landed."""

    def __init__(self, nbytes, rng):
        self.mem = rng.integers(-128, 128, nbytes).astype(np.int8)  # garbage
        self.groups, self.open = [], []

    def copy(self, dst, src):
        self.open.append((dst, src))

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    @staticmethod
    def _land(mem, group):
        for dst, src in group:
            mem[dst[:, None] + np.arange(16)] = src

    def wait(self, n):
        while len(self.groups) > n:
            self._land(self.mem, self.groups.pop(0))

    def eager(self):
        mem = self.mem.copy()
        for group in self.groups + [self.open]:
            self._land(mem, group)
        return mem


def gather(flat, starts, ok):
    """The 16-byte pieces flat[s:s + 16] where ok, zeros elsewhere: (256,
    16) int8."""
    return np.stack([flat[s:s + 16] if o else ZERO for s, o in zip(starts, ok)])


def chunk_steps(mutation=None):
    """The k32 steps a chunk issues: all four, those past K on zero-filled
    pieces."""
    return BK // 32 - (mutation == "steps")


def rehearse_gemm(a_loader, bk, m_all, k_all, plan, mutation=None, seed=0):
    """The int64 sums (M, N) of gemm_block over every block. a_loader(m0)
    returns the block's loader, which maps (i, r, k) (r = ROW0 + 32 i, k the
    thread's byte of K, arrays over the 256 threads) to the (256, 16) int8
    pieces it copies, zero where the kernel's a_src gives no source; bk is
    B as (N, K) int8 numpy."""
    n_all = bk.shape[0]
    assert bk.shape == (n_all, k_all)
    nk = -(-k_all // BK)
    bn, ns = plan.bn, plan.nstage
    lead = ns - (1 if mutation == "lead" else 2)
    sb = (BM + bn) * BK
    bf = bk.reshape(-1)
    offset = (lambda r, kb: r * 128 + kb) if mutation == "swizzle" else kmajor_offset
    rng = np.random.default_rng(seed)
    acc_out = np.full((m_all, n_all), -2 ** 62, np.int64)   # unwritten
    nt = -(-n_all // bn)
    for tile in range(-(-m_all // BM) * nt):    # each output tile
        m0, n0 = tile // nt * BM, tile % nt * bn
        a_src = a_loader(m0)
        ring = Ring(ns * sb, rng)

        def load(kc, st):
            k = kc * BK + 16 * PIECE
            for i in range(BM // 32):
                r = ROW0 + 32 * i
                ring.copy(st * sb + offset(r, 16 * PIECE), a_src(i, r, k))
            for i in range(bn // 32):
                r = ROW0 + 32 * i
                ok = (k < k_all) & (n0 + r < n_all)
                ring.copy(st * sb + BM * BK + offset(r, 16 * PIECE),
                          gather(bf, (n0 + r) * k_all + k, ok))

        def products(mem, st, steps):
            """Chunk in stage st: per warpgroup (rows 64 wg ..), the
            (64, bn) sum of its k32 steps."""
            b0 = st * sb + BM * BK
            return [sum(descriptor_read(mem, st * sb + 64 * wg * BK + 32 * kk, 64)
                        @ descriptor_read(mem, b0 + 32 * kk, bn).T
                        for kk in range(steps)) for wg in range(2)]

        acc = [np.zeros((64, bn), np.int64) for _ in range(2)]
        for s in range(lead):
            if s < nk:
                load(s, s)
            ring.commit()
        pending = None
        for kc in range(nk):
            ring.wait(lead - 1)
            st = kc % ns
            steps = chunk_steps(mutation)
            issued = products(ring.mem, st, steps)
            if kc + lead < nk:
                load(kc + lead, (kc + lead) % ns)
            ring.commit()
            if pending is not None:   # chunk kc - 1 retires
                late = products(ring.eager(), *pending[:2])
                if any((a != b).any() for a, b in zip(late, pending[2])):
                    raise AssertionError(f"chunk {kc - 1}: a stage was "
                                         f"overwritten while read")
                acc = [a + p for a, p in zip(acc, pending[2])]
            pending = (st, steps, issued)
        acc = [a + p for a, p in zip(acc, pending[2])]

        # the epilogue, through the fragment layout
        for wg in range(2):
            for warp in range(4):
                for lane in range(32):
                    for hf in range(2):
                        row = 16 * warp + (lane >> 2) + 8 * hf
                        m = m0 + 64 * wg + row
                        if m >= m_all:
                            continue
                        for j in range(bn // 8):
                            col = 8 * j + 2 * (lane & 3)
                            if n0 + col >= n_all:
                                break
                            acc_out[m, n0 + col:n0 + col + 2] = \
                                acc[wg][row, col:col + 2]
    assert (acc_out != -2 ** 62).all(), "an output the epilogue never wrote"
    return acc_out


def dequantize(acc, a_scale, b_scale, out_dtype=torch.float32):
    """The epilogue's arithmetic on the sums: f32(acc) * (a_scale *
    b_scale), the scale product in f32 first."""
    scale = np.float32(a_scale) * b_scale.astype(np.float32)
    return torch.from_numpy(acc.astype(np.float32) * scale).to(out_dtype)
