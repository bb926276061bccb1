// Native host-side BN254 core: 4x64-limb Montgomery fields, projective G1,
// Pippenger MSM.  The port's copy of the repository's csrc/bn254.cpp, which
// plays the role of the reference's Rust math core (snark-verifier
// src/util/{arithmetic,msm}.rs backed by halo2curves): an independent
// host oracle for the port's CUDA MSM.
//
// Build: utils/native.py compiles it with g++ at first use into the
// package's build/ directory, under a name that carries a hash of this file.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

struct FieldCtx {
    u64 p[4];     // modulus, little-endian limbs
    u64 r2[4];    // R^2 mod p
    u64 ninv;     // -p^{-1} mod 2^64
    u64 one[4];   // R mod p (Montgomery 1)
};

inline bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

inline void sub_p(u64 a[4], const u64 p[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a[i] - p[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

inline void cond_sub(u64 a[4], const u64 p[4]) {
    if (geq(a, p)) sub_p(a, p);
}

void fe_add(const FieldCtx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        out[i] = (u64)s;
        carry = s >> 64;
    }
    cond_sub(out, c->p);
}

void fe_sub(const FieldCtx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {  // add p back
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)out[i] + c->p[i] + carry;
            out[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

// CIOS Montgomery multiplication
void fe_mul(const FieldCtx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 v = (u128)a[i] * b[j] + t[j] + carry;
            t[j] = (u64)v;
            carry = v >> 64;
        }
        u128 v = (u128)t[4] + carry;
        t[4] = (u64)v;
        t[5] = (u64)(v >> 64);

        u64 m = t[0] * c->ninv;
        carry = 0;
        {
            u128 w = (u128)m * c->p[0] + t[0];
            carry = w >> 64;
        }
        for (int j = 1; j < 4; ++j) {
            u128 w = (u128)m * c->p[j] + t[j] + carry;
            t[j - 1] = (u64)w;
            carry = w >> 64;
        }
        u128 w = (u128)t[4] + carry;
        t[3] = (u64)w;
        t[4] = t[5] + (u64)(w >> 64);
        t[5] = 0;
    }
    memcpy(out, t, 32);
    cond_sub(out, c->p);
}

void fe_pow(const FieldCtx* c, const u64 a[4], const u64 e[4], u64 out[4]) {
    u64 base[4], acc[4];
    memcpy(base, a, 32);
    memcpy(acc, c->one, 32);
    for (int limb = 0; limb < 4; ++limb) {
        for (int bit = 0; bit < 64; ++bit) {
            if ((e[limb] >> bit) & 1) fe_mul(c, acc, base, acc);
            fe_mul(c, base, base, base);
        }
    }
    memcpy(out, acc, 32);
}

void fe_inv(const FieldCtx* c, const u64 a[4], u64 out[4]) {
    u64 e[4];  // p - 2
    memcpy(e, c->p, 32);
    u128 borrow = 2;
    for (int i = 0; i < 4 && borrow; ++i) {
        u128 d = (u128)e[i] - borrow;
        e[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    fe_pow(c, a, e, out);
}

// ---------------------------------------------------------------- curve ops
// projective (X:Y:Z), b = 3, b3 = 9; complete RC15 formulas matching the
// device kernels (ec/curve.py)

struct G1 {
    u64 x[4], y[4], z[4];
};

FieldCtx FQ_CTX;
FieldCtx FR_CTX;

inline void mul_small(const FieldCtx* c, const u64 a[4], int k, u64 out[4]) {
    u64 acc[4];
    memcpy(acc, a, 32);
    // k in {8, 9}: 3 doublings (+a)
    fe_add(c, acc, acc, acc);
    fe_add(c, acc, acc, acc);
    fe_add(c, acc, acc, acc);
    if (k == 9) fe_add(c, acc, a, acc);
    memcpy(out, acc, 32);
}

void g1_add(const G1* p, const G1* q, G1* out) {
    const FieldCtx* c = &FQ_CTX;
    u64 t0[4], t1[4], t2[4], t3[4], t4[4], ty[4], t03[4], t2b[4], z3l[4], t1m[4], yb[4];
    u64 s1[4], s2[4], s3[4];
    fe_mul(c, p->x, q->x, t0);
    fe_mul(c, p->y, q->y, t1);
    fe_mul(c, p->z, q->z, t2);
    fe_add(c, p->x, p->y, s1);
    fe_add(c, q->x, q->y, s2);
    fe_mul(c, s1, s2, t3);
    fe_add(c, t0, t1, s3);
    fe_sub(c, t3, s3, t3);  // X1Y2+X2Y1
    fe_add(c, p->y, p->z, s1);
    fe_add(c, q->y, q->z, s2);
    fe_mul(c, s1, s2, t4);
    fe_add(c, t1, t2, s3);
    fe_sub(c, t4, s3, t4);  // Y1Z2+Y2Z1
    fe_add(c, p->x, p->z, s1);
    fe_add(c, q->x, q->z, s2);
    fe_mul(c, s1, s2, ty);
    fe_add(c, t0, t2, s3);
    fe_sub(c, ty, s3, ty);  // X1Z2+X2Z1
    fe_add(c, t0, t0, t03);
    fe_add(c, t03, t0, t03);  // 3 X1X2
    mul_small(c, t2, 9, t2b);  // 3b Z1Z2
    fe_add(c, t1, t2b, z3l);
    fe_sub(c, t1, t2b, t1m);
    mul_small(c, ty, 9, yb);  // 3b (X1Z2+X2Z1)
    u64 m0[4], m1[4], m2[4], m3[4], m4[4], m5[4];
    fe_mul(c, t3, t1m, m0);
    fe_mul(c, t4, yb, m1);
    fe_mul(c, yb, t03, m2);
    fe_mul(c, t1m, z3l, m3);
    fe_mul(c, t03, t3, m4);
    fe_mul(c, z3l, t4, m5);
    fe_sub(c, m0, m1, out->x);
    fe_add(c, m3, m2, out->y);
    fe_add(c, m5, m4, out->z);
}

void g1_double(const G1* p, G1* out) { g1_add(p, p, out); }

void g1_scalar_mul(const G1* p, const u64 k[4], G1* out) {
    G1 acc;
    memset(&acc, 0, sizeof(acc));
    memcpy(acc.y, FQ_CTX.one, 32);  // (0 : 1 : 0)
    bool started = false;
    for (int limb = 3; limb >= 0; --limb) {
        for (int bit = 63; bit >= 0; --bit) {
            if (started) g1_double(&acc, &acc);
            if ((k[limb] >> bit) & 1) {
                if (started) {
                    g1_add(&acc, p, &acc);
                } else {
                    acc = *p;
                    started = true;
                }
            }
        }
    }
    *out = acc;
}

}  // namespace

extern "C" {

void bn254_init(const u64* fq_p, const u64* fq_r2, u64 fq_ninv, const u64* fq_one,
                const u64* fr_p, const u64* fr_r2, u64 fr_ninv, const u64* fr_one) {
    memcpy(FQ_CTX.p, fq_p, 32);
    memcpy(FQ_CTX.r2, fq_r2, 32);
    FQ_CTX.ninv = fq_ninv;
    memcpy(FQ_CTX.one, fq_one, 32);
    memcpy(FR_CTX.p, fr_p, 32);
    memcpy(FR_CTX.r2, fr_r2, 32);
    FR_CTX.ninv = fr_ninv;
    memcpy(FR_CTX.one, fr_one, 32);
}

// batch field ops over Fr (idx 0) or Fq (idx 1); arrays of n*4 limbs
void bn254_fe_mul_batch(int field, const u64* a, const u64* b, u64* out, long n) {
    const FieldCtx* c = field ? &FQ_CTX : &FR_CTX;
    for (long i = 0; i < n; ++i) fe_mul(c, a + 4 * i, b + 4 * i, out + 4 * i);
}

void bn254_fe_inv_batch(int field, const u64* a, u64* out, long n) {
    const FieldCtx* c = field ? &FQ_CTX : &FR_CTX;
    for (long i = 0; i < n; ++i) fe_inv(c, a + 4 * i, out + 4 * i);
}

// points: n * 12 limbs (x,y,z Montgomery projective); scalars: n * 4 limbs
// (plain, NOT Montgomery).  out: 12 limbs.
void bn254_msm(const u64* points, const u64* scalars, long n, u64* out) {
    // Pippenger, c=8 windows (mirrors reference util/msm.rs semantics)
    const int CBITS = 8, NBUCKETS = 255, NWIN = 32;
    G1 acc;
    memset(&acc, 0, sizeof(acc));
    memcpy(acc.y, FQ_CTX.one, 32);
    G1* buckets = new G1[NBUCKETS];
    for (int w = NWIN - 1; w >= 0; --w) {
        for (int d = 0; d < CBITS && !(w == NWIN - 1); ++d) g1_double(&acc, &acc);
        for (int b = 0; b < NBUCKETS; ++b) {
            memset(&buckets[b], 0, sizeof(G1));
            memcpy(buckets[b].y, FQ_CTX.one, 32);
        }
        for (long i = 0; i < n; ++i) {
            int limb = (w * 8) / 64;
            int shift = (w * 8) % 64;
            int digit = (int)((scalars[4 * i + limb] >> shift) & 0xFF);
            if (digit) g1_add(&buckets[digit - 1], (const G1*)(points + 12 * i),
                              &buckets[digit - 1]);
        }
        G1 running, wsum;
        memset(&running, 0, sizeof(G1));
        memcpy(running.y, FQ_CTX.one, 32);
        wsum = running;
        for (int b = NBUCKETS - 1; b >= 0; --b) {
            g1_add(&running, &buckets[b], &running);
            g1_add(&wsum, &running, &wsum);
        }
        g1_add(&acc, &wsum, &acc);
    }
    delete[] buckets;
    memcpy(out, &acc, 96);
}

// Multithreaded Pippenger: chunk-split across threads + projective reduce,
// the CPU-baseline counterpart of the reference's rayon parallel MSM
// (snark-verifier src/util/msm.rs:290-310): the host's multithreaded MSM
// rate, the JAX package's bench.py CPU baseline.
void bn254_msm_mt(const u64* points, const u64* scalars, long n, int nthreads,
                  u64* out) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    std::vector<G1> partial(nthreads);
    std::vector<std::thread> threads;
    long chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        long lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        threads.emplace_back([&, t, lo, hi]() {
            if (lo >= hi) {
                memset(&partial[t], 0, sizeof(G1));
                memcpy(partial[t].y, FQ_CTX.one, 32);
                return;
            }
            bn254_msm(points + 12 * lo, scalars + 4 * lo, hi - lo,
                      (u64*)&partial[t]);
        });
    }
    for (auto& th : threads) th.join();
    G1 acc = partial[0];
    for (int t = 1; t < nthreads; ++t) g1_add(&acc, &partial[t], &acc);
    memcpy(out, &acc, 96);
}

// out[i] = (i+1)*G for i in 0..n-1 (bench/test point generation):
// n sequential projective adds — seconds for 2^20 vs minutes of device
// compile for the equivalent on-chip doubling ladder.
void bn254_enumerate_points(const u64* g, long n, u64* out) {
    G1 acc;
    memcpy(&acc, g, 96);
    memcpy(out, &acc, 96);
    for (long i = 1; i < n; ++i) {
        g1_add(&acc, (const G1*)g, &acc);
        memcpy(out + 12 * i, &acc, 96);
    }
}

// Pippenger slot assignment on the host: the device MSM's prep phase
// (digit extraction -> stable rank-in-bucket -> slot-index matrices) is
// pure integer bookkeeping whose XLA module costs ~20 min of remote
// compile for 0.7s of runtime; counting it on the CPU is ~100ms and
// compiles nothing.  Layout matches msm/pippenger._slot_indices: windows
// 0..W-2 get (n_buckets, cap) int32 point indices (sentinel n = the
// infinity row), the top window gets (trange, tcap); digit-0 entries are
// dropped; a bucket exceeding its capacity sets *overflow (detect, never
// silently drop — the caller retries with a larger capacity).
void bn254_slot_indices(const u64* scalars, long n, int c, long cap,
                        long trange, long tcap, int* idx_main, int* idx_top,
                        int* overflow, int nthreads) {
    const int W = (256 + c - 1) / c;
    const long nb = 1L << c;
    const u64 mask = (1ULL << c) - 1;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    std::vector<int> ovf(W, 0);
    auto do_window = [&](int w) {
        const bool top = (w == W - 1);
        const long nbw = top ? trange : nb;
        const long capw = top ? tcap : cap;
        int* out = top ? idx_top : idx_main + (long)w * nb * cap;
        for (long j = 0; j < nbw * capw; ++j) out[j] = (int)n;
        std::vector<long> counters(nbw, 0);
        const int bit0 = w * c;
        const int limb = bit0 >> 6, off = bit0 & 63;
        for (long i = 0; i < n; ++i) {
            const u64* s = scalars + 4 * i;
            u64 d = s[limb] >> off;
            if (off + c > 64 && limb + 1 < 4) d |= s[limb + 1] << (64 - off);
            d &= mask;
            if (!d) continue;
            long r = counters[d]++;
            if (r < capw) out[d * capw + r] = (int)i;
            else ovf[w] = 1;
        }
    };
    std::vector<std::thread> threads;
    std::atomic<int> next(0);
    for (int t = 0; t < nthreads; ++t)
        threads.emplace_back([&]() {
            int w;
            while ((w = next.fetch_add(1)) < W) do_window(w);
        });
    for (auto& th : threads) th.join();
    *overflow = 0;
    for (int w = 0; w < W; ++w) *overflow |= ovf[w];
}

void bn254_scalar_mul(const u64* point, const u64* scalar, u64* out) {
    G1 r;
    g1_scalar_mul((const G1*)point, scalar, &r);
    memcpy(out, &r, 96);
}

// powers of tau times G: out[i] = tau^i * G, i = 0..n-1 (for toy SRS)
void bn254_srs_powers(const u64* g, const u64* tau_plain, long n, u64* out) {
    // tau in plain form; iterate k *= tau in Fr Montgomery domain
    u64 tau_m[4], k_m[4], k_plain[4];
    fe_mul(&FR_CTX, tau_plain, FR_CTX.r2, tau_m);  // to Montgomery
    memcpy(k_m, FR_CTX.one, 32);
    for (long i = 0; i < n; ++i) {
        u64 one_plain[4] = {1, 0, 0, 0};
        fe_mul(&FR_CTX, k_m, one_plain, k_plain);  // from Montgomery
        G1 r;
        g1_scalar_mul((const G1*)g, k_plain, &r);
        memcpy(out + 12 * i, &r, 96);
        fe_mul(&FR_CTX, k_m, tau_m, k_m);
    }
}

}  // extern "C"
