// Scalar field arithmetic for the native harness: M31 tower + F_{3*2^30+1}.
// Semantics mirror stark_symphony/ops/field.py and field101.py (which
// themselves mirror /root/reference/stwo-verifier/src/fields/*.simf and
// /root/reference/stark101/src/field.simf).
#pragma once

#include <cstdint>

namespace symphony {

constexpr uint32_t M31_P = 0x7fffffff;
constexpr uint32_t F101_Q = 3221225473u;  // 3 * 2^30 + 1

// ----- M31 -----
inline uint32_t m31_add(uint32_t a, uint32_t b) {
  uint64_t s = uint64_t(a) + b;  // a, b canonical => s < 2P
  return uint32_t(s >= M31_P ? s - M31_P : s);
}
inline uint32_t m31_mul(uint32_t a, uint32_t b) {
  return uint32_t((uint64_t(a) * b) % M31_P);
}
inline uint32_t m31_neg(uint32_t a) { return a == 0 ? 0 : M31_P - a; }
inline uint32_t m31_sub(uint32_t a, uint32_t b) { return m31_add(a, m31_neg(b)); }
inline uint32_t m31_pow(uint32_t a, uint64_t e) {
  uint64_t r = 1, base = a;
  while (e) {
    if (e & 1) r = (r * base) % M31_P;
    base = (base * base) % M31_P;
    e >>= 1;
  }
  return uint32_t(r);
}
inline uint32_t m31_inv(uint32_t a) { return m31_pow(a, M31_P - 2); }

struct CM31 {
  uint32_t r = 0, i = 0;
};
inline CM31 cadd(CM31 a, CM31 b) { return {m31_add(a.r, b.r), m31_add(a.i, b.i)}; }
inline CM31 csub(CM31 a, CM31 b) { return {m31_sub(a.r, b.r), m31_sub(a.i, b.i)}; }
inline CM31 cneg(CM31 a) { return {m31_neg(a.r), m31_neg(a.i)}; }
inline CM31 cmul(CM31 a, CM31 b) {
  return {m31_sub(m31_mul(a.r, b.r), m31_mul(a.i, b.i)),
          m31_add(m31_mul(a.r, b.i), m31_mul(a.i, b.r))};
}
inline CM31 cinv(CM31 a) {
  uint32_t n = m31_inv(m31_add(m31_mul(a.r, a.r), m31_mul(a.i, a.i)));
  return {m31_mul(a.r, n), m31_mul(m31_neg(a.i), n)};
}

struct QM31 {
  CM31 a, b;  // a + b*j, j^2 = 2 + i
  bool operator==(const QM31& o) const {
    return a.r == o.a.r && a.i == o.a.i && b.r == o.b.r && b.i == o.b.i;
  }
};
inline QM31 qm31(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3) {
  return {{x0, x1}, {x2, x3}};
}
inline QM31 qadd(QM31 x, QM31 y) { return {cadd(x.a, y.a), cadd(x.b, y.b)}; }
inline QM31 qsub(QM31 x, QM31 y) { return {csub(x.a, y.a), csub(x.b, y.b)}; }
inline QM31 qmul(QM31 x, QM31 y) {
  CM31 R{2, 1};
  return {cadd(cmul(x.a, y.a), cmul(cmul(x.b, y.b), R)),
          cadd(cmul(x.a, y.b), cmul(x.b, y.a))};
}
inline QM31 qmul_m31(QM31 x, uint32_t s) {
  return {{m31_mul(x.a.r, s), m31_mul(x.a.i, s)},
          {m31_mul(x.b.r, s), m31_mul(x.b.i, s)}};
}
inline QM31 qmul_cm31(QM31 x, CM31 c) { return {cmul(x.a, c), cmul(x.b, c)}; }
inline QM31 qinv(QM31 x) {
  CM31 a2 = cmul(x.a, x.a), b2 = cmul(x.b, x.b);
  CM31 b2d = cadd(b2, b2);
  CM31 b2i{m31_neg(b2.i), b2.r};  // i * b^2
  CM31 den = csub(a2, cadd(b2d, b2i));
  CM31 di = cinv(den);
  return {cmul(x.a, di), cmul(cneg(x.b), di)};
}

// ----- F_q, q = 3*2^30+1 -----
inline uint32_t f_add(uint32_t a, uint32_t b) {
  return uint32_t((uint64_t(a) + b) % F101_Q);
}
inline uint32_t f_mul(uint32_t a, uint32_t b) {
  return uint32_t((uint64_t(a) * b) % F101_Q);
}
inline uint32_t f_neg(uint32_t a) { return a == 0 ? 0 : F101_Q - a; }
inline uint32_t f_sub(uint32_t a, uint32_t b) { return f_add(a, f_neg(b)); }
inline uint32_t f_pow(uint32_t a, uint64_t e) {
  uint64_t r = 1, base = a;
  while (e) {
    if (e & 1) r = (r * base) % F101_Q;
    base = (base * base) % F101_Q;
    e >>= 1;
  }
  return uint32_t(r);
}
inline uint32_t f_inv(uint32_t a) { return f_pow(a, uint64_t(F101_Q) - 2); }

// ----- M31 circle group -----
struct Pt {
  uint32_t x = 1, y = 0;
};
inline Pt pt_add(Pt p, Pt q) {
  return {m31_sub(m31_mul(p.x, q.x), m31_mul(p.y, q.y)),
          m31_add(m31_mul(p.x, q.y), m31_mul(p.y, q.x))};
}
inline Pt pt_from_index(uint32_t idx) {
  Pt res;             // identity
  Pt cur{2, 1268011823};  // generator (m31_point.simf:13)
  for (int k = 0; k < 31; k++) {
    if ((idx >> k) & 1) res = pt_add(res, cur);
    cur = pt_add(cur, cur);
  }
  return res;
}

inline uint32_t bit_reverse(uint32_t x, int bits) {
  uint32_t r = 0;
  for (int i = 0; i < bits; i++) r |= ((x >> i) & 1u) << (bits - 1 - i);
  return r;
}

// canonic circle domain position -> point index (circle_domain.simf:27-37)
inline uint32_t circle_pos_to_index(int log_size, uint32_t pos) {
  uint32_t half = 1u << (log_size - 1);
  uint32_t offset = 1u << (31 - (log_size + 1));
  uint32_t step = 1u << (31 - (log_size - 1));
  uint32_t mask = (1u << 31) - 1;
  if (pos < half) return (offset + step * pos) & mask;
  uint32_t idx = (offset + step * (pos - half)) & mask;
  return ((1u << 31) - idx) & mask;
}

inline uint32_t line_pos_to_x(int log_size, uint32_t pos) {
  uint32_t offset = 1u << (31 - (log_size + 2));
  uint32_t step = 1u << (31 - log_size);
  uint32_t mask = (1u << 31) - 1;
  return pt_from_index((offset + step * pos) & mask).x;
}

}  // namespace symphony
