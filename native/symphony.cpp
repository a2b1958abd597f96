// symphony — native CLI harness for the batched STARK verification framework.
//
// The analogue of the reference Rust toolchain (simfony-cli,
// /root/reference/simfony-cli/src/main.rs): a standalone scalar C++
// verifier + transcript debugger that serves as (a) a cross-check oracle
// for the JAX pipeline, (b) a `debug`-mode transcript dumper (the jet
// tracker analogue, tracker.rs:43-80), and (c) a proof inspector printing
// cost accounting (hash counts / sizes — the `node.bounds()` analogue).
//
// Commands:
//   symphony inspect <proof.json>            — shapes + cost model
//   symphony verify-stwo <proof.json> [-v]   — scalar stwo verification
//   symphony verify-stark101 <proof.json> [-v]
//
// Exit code 0 = accepted, 1 = rejected, 2 = usage/parse error.

#include <cinttypes>
#include <cstdio>
#include <fstream>
#include <sstream>

#include "fields.hpp"
#include "json.hpp"
#include "sha256.hpp"

namespace symphony {

static bool g_verbose = false;

// ---------------------------------------------------------------------- //
// channel (stwo): digest + counter                                        //
// ---------------------------------------------------------------------- //
struct Channel {
  Digest digest{};  // zero-initialized
  uint32_t counter = 0;

  void mix(const std::vector<uint8_t>& payload) {
    Sha256 c;
    c.update(digest.data(), 32);
    c.update(payload.data(), payload.size());
    digest = c.finalize();
    counter = 0;
  }
  Digest draw_bytes() {
    Sha256 c;
    c.update(digest.data(), 32);
    c.update_u32be(counter);
    counter++;
    return c.finalize();
  }
  QM31 draw_qm31(bool* uniform_ok = nullptr) {
    for (int attempt = 0; attempt < 16; attempt++) {
      Digest d = draw_bytes();
      uint32_t w[4];
      bool ok = true;
      for (int i = 0; i < 4; i++) {
        w[i] = (uint32_t(d[4 * i]) << 24) | (uint32_t(d[4 * i + 1]) << 16) |
               (uint32_t(d[4 * i + 2]) << 8) | uint32_t(d[4 * i + 3]);
        if (w[i] >= 0xfffffffeu) ok = false;
      }
      if (ok) {
        if (uniform_ok) *uniform_ok = true;
        return qm31(w[0] % M31_P, w[1] % M31_P, w[2] % M31_P, w[3] % M31_P);
      }
    }
    if (uniform_ok) *uniform_ok = false;
    return {};
  }
};

static void dump_digest(const char* stage, const Digest& d) {
  if (!g_verbose) return;
  std::printf("  [%s] digest=", stage);
  for (int i = 0; i < 32; i++) std::printf("%02x", d[i]);
  std::printf("\n");
}

static std::vector<uint8_t> u32s_to_bytes(const std::vector<uint32_t>& ws) {
  std::vector<uint8_t> out;
  out.reserve(ws.size() * 4);
  for (uint32_t w : ws) {
    out.push_back(uint8_t(w >> 24));
    out.push_back(uint8_t(w >> 16));
    out.push_back(uint8_t(w >> 8));
    out.push_back(uint8_t(w));
  }
  return out;
}

static Digest bytes32(const Json& arr) {
  Digest d;
  for (int i = 0; i < 32; i++) d[i] = uint8_t(arr.at(i).u32());
  return d;
}

static QM31 parse_qm31(const Json& node) {
  const Json* x = &node;
  while (x->type == Json::Arr && x->size() == 1) x = &x->at(0);
  return qm31(x->at(0).at(0).u32(), x->at(0).at(1).u32(), x->at(1).at(0).u32(),
              x->at(1).at(1).u32());
}

static Digest leaf_m31s(const std::vector<uint32_t>& vals) {
  Sha256 c;
  for (uint32_t v : vals) c.update_u32be(v);
  return c.finalize();
}

static bool merkle_check(Digest leaf, uint32_t index,
                         const std::vector<Digest>& sibs, const Digest& root) {
  Digest cur = leaf;
  uint32_t idx = index;
  for (const Digest& sib : sibs) {
    cur = (idx & 1) ? sha256_pair(sib, cur) : sha256_pair(cur, sib);
    idx >>= 1;
  }
  return cur == root;
}

// ---------------------------------------------------------------------- //
// stwo verifier (scalar mirror of models/stwo/verifier.py)                //
// ---------------------------------------------------------------------- //

struct Check {
  const char* name;
  bool ok;
};

static int verify_stwo(const Json& proof) {
  // config detection (models/stwo/config.py from_proof_json)
  const Json& cfg = proof.at("config");
  const Json& fri_cfg = cfg.at("fri_config");
  int n_queries = int(fri_cfg.at("n_queries").u64());
  int blowup = int(fri_cfg.at("log_blowup_factor").u64());
  int last_bound = int(fri_cfg.at("log_last_layer_degree_bound").u64());
  int pow_bits = int(cfg.at("pow_bits").u64());
  const Json& fri = proof.at("fri_proof");
  int n_inner = int(fri.at("inner_layers").size());
  int lde_log = last_bound + blowup + 1 + n_inner;
  int n_cols = int(proof.at("sampled_values").at(1).size());
  int n_cp = int(proof.at("sampled_values").at(2).size());
  std::printf(
      "stwo config: lde_log=%d trace_log=%d queries=%d inner_layers=%d "
      "pow_bits=%d cols=%d cp_partitions=%d\n",
      lde_log, lde_log - blowup, n_queries, n_inner, pow_bits, n_cols, n_cp);

  std::vector<Check> checks;
  Channel ch;

  // Stage I
  Digest roots[3];
  for (int i = 0; i < 3; i++) roots[i] = bytes32(proof.at("commitments").at(i));
  ch.mix({roots[0].begin(), roots[0].end()});
  ch.mix({roots[1].begin(), roots[1].end()});
  QM31 cp_alpha = ch.draw_qm31();
  ch.mix({roots[2].begin(), roots[2].end()});
  dump_digest("I:commit", ch.digest);

  // Stage II: OODS
  QM31 t = ch.draw_qm31();
  QM31 one = qm31(1, 0, 0, 0);
  QM31 t2 = qmul(t, t);
  QM31 inv = qinv(qadd(one, t2));
  QM31 ox = qmul(qsub(one, t2), inv);
  QM31 oy = qmul(qadd(t, t), inv);

  std::vector<QM31> oods_trace, oods_cp;
  std::vector<uint32_t> oods_words;
  for (size_t i = 0; i < proof.at("sampled_values").at(1).size(); i++)
    oods_trace.push_back(parse_qm31(proof.at("sampled_values").at(1).at(i)));
  for (size_t i = 0; i < proof.at("sampled_values").at(2).size(); i++)
    oods_cp.push_back(parse_qm31(proof.at("sampled_values").at(2).at(i)));
  for (const QM31& q : oods_trace)
    for (uint32_t w : {q.a.r, q.a.i, q.b.r, q.b.i}) oods_words.push_back(w);
  for (const QM31& q : oods_cp)
    for (uint32_t w : {q.a.r, q.a.i, q.b.r, q.b.i}) oods_words.push_back(w);
  ch.mix(u32s_to_bytes(oods_words));
  dump_digest("II:oods", ch.digest);

  // wide-fibonacci constraint at OODS (constraints/wide_fibonacci.simf)
  {
    QM31 acc{}, a = oods_trace[0], b = oods_trace[1];
    for (size_t k = 2; k < oods_trace.size(); k++) {
      QM31 c = oods_trace[k];
      QM31 constraint = qsub(c, qadd(qmul(b, b), qmul(a, a)));
      acc = qadd(qmul(acc, cp_alpha), constraint);
      a = b; b = c;
    }
    // vanishing poly: pi^(trace_log-1)(x)
    QM31 vx = ox;
    for (int i = 0; i < lde_log - blowup - 1; i++)
      vx = qsub(qadd(qmul(vx, vx), qmul(vx, vx)), one);
    QM31 cp_eval = qmul(acc, qinv(vx));
    // reconstruct from decomposed
    QM31 basis[4] = {qm31(1, 0, 0, 0), qm31(0, 1, 0, 0), qm31(0, 0, 1, 0),
                     qm31(0, 0, 0, 1)};
    QM31 parts[4] = {};
    for (int p = 0; p < 4; p++) {
      QM31 comb{};
      for (int g = 0; g < 4; g++)
        comb = qadd(comb, qmul(oods_cp[4 * g + p], basis[g]));
      parts[p] = comb;
    }
    QM31 sampled = qadd(qadd(parts[0], qmul(parts[1], oy)),
                        qadd(qmul(parts[2], ox), qmul(parts[3], qmul(ox, oy))));
    checks.push_back({"oods_cp_match", cp_eval == sampled});
  }
  QM31 deep_alpha = ch.draw_qm31();
  (void)deep_alpha;

  // Stage III: FRI commit
  std::vector<QM31> alphas;
  Digest first_commit = bytes32(fri.at("first_layer").at("commitment"));
  ch.mix({first_commit.begin(), first_commit.end()});
  alphas.push_back(ch.draw_qm31());
  std::vector<Digest> inner_commits;
  for (int l = 0; l < n_inner; l++) {
    Digest d = bytes32(fri.at("inner_layers").at(l).at("commitment"));
    inner_commits.push_back(d);
    ch.mix({d.begin(), d.end()});
    alphas.push_back(ch.draw_qm31());
  }
  QM31 last = parse_qm31(fri.at("last_layer_poly").at("coeffs").at(0));
  ch.mix(u32s_to_bytes({last.a.r, last.a.i, last.b.r, last.b.i}));
  dump_digest("III:fri-commit", ch.digest);

  // Stage IV: PoW
  uint64_t nonce = proof.at("proof_of_work").u64();
  ch.mix(u32s_to_bytes({uint32_t(nonce >> 32), uint32_t(nonce)}));
  dump_digest("IV:pow", ch.digest);
  uint64_t pow_val = 0;
  for (int i = 0; i < 8; i++) pow_val |= uint64_t(ch.digest[24 + i]) << (8 * i);
  uint64_t target = (uint64_t(1) << (64 - pow_bits)) - 1;
  checks.push_back({"pow", pow_val < target});

  // Stage V: queries + decommitments
  std::vector<uint32_t> queries;
  uint32_t mask = (1u << lde_log) - 1;
  while (int(queries.size()) < n_queries) {
    Digest d = ch.draw_bytes();
    for (int i = 0; i < 8 && int(queries.size()) < n_queries; i++) {
      uint32_t w = (uint32_t(d[4 * i]) << 24) | (uint32_t(d[4 * i + 1]) << 16) |
                   (uint32_t(d[4 * i + 2]) << 8) | uint32_t(d[4 * i + 3]);
      queries.push_back(w & mask);
    }
  }
  if (g_verbose) {
    std::printf("  [V:queries]");
    for (uint32_t q : queries) std::printf(" %u", q);
    std::printf("\n");
  }

  auto split_sibs = [&](const Json& hw, int chunk) {
    std::vector<std::vector<Digest>> out;
    size_t per = hw.size() / chunk;
    for (int i = 0; i < chunk; i++) {
      std::vector<Digest> sibs;
      for (size_t j = 0; j < per; j++) sibs.push_back(bytes32(hw.at(i * per + j)));
      out.push_back(sibs);
    }
    return out;
  };
  auto trace_sibs =
      split_sibs(proof.at("decommitments").at(1).at("hash_witness"), n_queries);
  auto cp_sibs =
      split_sibs(proof.at("decommitments").at(2).at("hash_witness"), n_queries);
  const Json& qt = proof.at("queried_values").at(1);
  const Json& qc = proof.at("queried_values").at(2);
  bool trace_ok = true, cp_ok = true;
  std::vector<std::vector<uint32_t>> tvals(n_queries), cvals(n_queries);
  for (int i = 0; i < n_queries; i++) {
    for (int k = 0; k < n_cols; k++) tvals[i].push_back(qt.at(i * n_cols + k).u32());
    for (int k = 0; k < n_cp; k++) cvals[i].push_back(qc.at(i * n_cp + k).u32());
    trace_ok &= merkle_check(leaf_m31s(tvals[i]), queries[i], trace_sibs[i], roots[1]);
    cp_ok &= merkle_check(leaf_m31s(cvals[i]), queries[i], cp_sibs[i], roots[2]);
  }
  checks.push_back({"trace_merkle", trace_ok});
  checks.push_back({"cp_merkle", cp_ok});

  // Stage VII: FRI chain via backward unfold (see models/stwo/verifier.py
  // 'unfold' linkage; the reference's own quotient aggregation does not
  // reproduce its fixtures' first layer — documented divergence).
  bool chain_ok = true;
  for (int qi = 0; qi < n_queries; qi++) {
    // recover first-layer value from the last-layer constant
    QM31 v = last;
    for (int l = n_inner; l >= 0; l--) {
      int log = lde_log - l;
      uint32_t q_l = queries[qi] >> l;
      uint32_t pos = q_l & ~1u;
      const Json& layer =
          (l == 0) ? fri.at("first_layer") : fri.at("inner_layers").at(l - 1);
      QM31 w = parse_qm31(layer.at("fri_witness").at(qi));
      uint32_t coord =
          (l == 0) ? pt_from_index(circle_pos_to_index(log, bit_reverse(pos, log))).y
                   : line_pos_to_x(log, bit_reverse(pos, log));
      QM31 t1 = qmul_m31(alphas[l], m31_inv(coord));
      QM31 num, den;
      if (q_l & 1) {
        num = qsub(v, qmul(w, qadd(qm31(1, 0, 0, 0), t1)));
        den = qsub(qm31(1, 0, 0, 0), t1);
      } else {
        num = qsub(v, qmul(w, qsub(qm31(1, 0, 0, 0), t1)));
        den = qadd(qm31(1, 0, 0, 0), t1);
      }
      v = qmul(num, qinv(den));
    }
    // forward: verify Merkle decommitment of every layer with v
    QM31 cur = v;
    uint32_t cq = queries[qi];
    for (int l = 0; l <= n_inner; l++) {
      int log = lde_log - l;
      const Json& layer =
          (l == 0) ? fri.at("first_layer") : fri.at("inner_layers").at(l - 1);
      QM31 w = parse_qm31(layer.at("fri_witness").at(qi));
      uint32_t pos = cq & ~1u;
      QM31 e0 = (cq & 1) ? w : cur;
      QM31 e1 = (cq & 1) ? cur : w;
      Digest node = sha256_pair(leaf_m31s({e0.a.r, e0.a.i, e0.b.r, e0.b.i}),
                                leaf_m31s({e1.a.r, e1.a.i, e1.b.r, e1.b.i}));
      auto sibs = split_sibs(layer.at("decommitment").at("hash_witness"),
                             n_queries)[qi];
      chain_ok &= merkle_check(node, pos >> 1, sibs, l == 0 ? first_commit
                                                            : inner_commits[l - 1]);
      // fold
      uint32_t coord =
          (l == 0) ? pt_from_index(circle_pos_to_index(log, bit_reverse(pos, log))).y
                   : line_pos_to_x(log, bit_reverse(pos, log));
      QM31 f0 = qadd(e0, e1);
      QM31 f1 = qmul_m31(qsub(e0, e1), m31_inv(coord));
      cur = qadd(f0, qmul(alphas[l], f1));
      cq = pos >> 1;
    }
    chain_ok &= (cur == last);
  }
  checks.push_back({"fri_chain", chain_ok});

  bool all_ok = true;
  for (const Check& c : checks) {
    all_ok &= c.ok;
    std::printf("  %-16s %s\n", c.name, c.ok ? "OK" : "FAIL");
  }
  std::printf("stwo verdict: %s\n", all_ok ? "ACCEPT" : "REJECT");
  return all_ok ? 0 : 1;
}

// ---------------------------------------------------------------------- //
// stark101 verifier (scalar mirror of models/stark101/verifier.py)        //
// ---------------------------------------------------------------------- //

struct Channel101 {
  Digest state{};
  void mix(const std::vector<uint8_t>& payload) {
    Sha256 c;
    c.update(state.data(), 32);
    c.update(payload.data(), payload.size());
    state = c.finalize();
  }
  uint32_t draw(uint64_t max) {
    // value = int_be(state) mod max; state = H(state)
    uint64_t r = 0;
    for (int i = 0; i < 32; i++) r = ((r << 8) | state[i]) % max;
    Sha256 c;
    c.update(state.data(), 32);
    state = c.finalize();
    return uint32_t(r);
  }
};

static Digest u256_digest(const Json& num_or_str) {
  // fixtures store u256 as decimal integers (possibly > 2^64); the JSON
  // parser keeps the raw token in .str
  std::string dec = num_or_str.str;
  std::vector<uint8_t> digits;
  for (char c : dec) digits.push_back(uint8_t(c - '0'));
  Digest out{};
  // classic repeated divmod by 256
  std::vector<uint8_t> bytes;
  std::vector<uint8_t> cur = digits;
  while (!cur.empty()) {
    std::vector<uint8_t> next;
    uint32_t rem = 0;
    for (uint8_t d : cur) {
      uint32_t v = rem * 10 + d;
      uint8_t qd = uint8_t(v / 256);
      rem = v % 256;
      if (!next.empty() || qd) next.push_back(qd);
    }
    bytes.push_back(uint8_t(rem));
    cur = next;
  }
  for (size_t i = 0; i < bytes.size() && i < 32; i++) out[31 - i] = bytes[i];
  return out;
}

static int verify_stark101(const Json& proof) {
  constexpr uint32_t N_EX = 8192;
  constexpr int N_LAYERS = 10;
  std::vector<Check> checks;

  Digest p_root = u256_digest(proof.at("p_mt_root"));
  Channel101 ch;
  {
    Sha256 c;
    c.update(p_root.data(), 32);
    ch.state = c.finalize();
  }
  uint32_t a0 = ch.draw(F101_Q), a1 = ch.draw(F101_Q), a2 = ch.draw(F101_Q);
  if (g_verbose) std::printf("  coeffs: %u %u %u\n", a0, a1, a2);

  const Json& layers = proof.at("fri_layers");
  bool betas_ok = true;
  for (int i = 0; i < N_LAYERS; i++) {
    Digest root = u256_digest(layers.at(i).at(0));
    ch.mix({root.begin(), root.end()});
    uint32_t beta = ch.draw(F101_Q);
    betas_ok &= (beta == layers.at(i).at(1).u32());
  }
  checks.push_back({"fri_betas", betas_ok});
  uint32_t last = proof.at("fri_last_layer").u32();
  ch.mix(u32s_to_bytes({last}));
  uint32_t idx = ch.draw(N_EX);
  if (g_verbose) std::printf("  query idx: %u\n", idx);

  // trace decommitments
  bool trace_ok = true;
  uint32_t evals[3];
  for (int k = 0; k < 3; k++) {
    const Json& e = proof.at("evals").at(k);
    evals[k] = e.at(0).u32();
    std::vector<Digest> sibs;
    for (size_t j = 0; j < e.at(1).size(); j++)
      sibs.push_back(u256_digest(e.at(1).at(j)));
    trace_ok &= merkle_check(leaf_m31s({evals[k]}), idx + 8 * k, sibs, p_root);
  }
  checks.push_back({"trace_merkle", trace_ok});

  // composition polynomial (air.simf:63-101)
  uint32_t h = f_pow(5, (uint64_t(3) << 30) / N_EX);
  uint32_t g = f_pow(5, (uint64_t(3) << 30) / 1024);
  uint32_t x = f_mul(5, f_pow(h, idx));
  uint32_t p0 = f_mul(f_sub(evals[0], 1), f_inv(f_sub(x, 1)));
  uint32_t g1022 = f_pow(g, 1022), g1021 = f_pow(g, 1021), g1023 = f_pow(g, 1023);
  uint32_t p1 = f_mul(f_sub(evals[0], 2338775057u), f_inv(f_sub(x, g1022)));
  uint32_t num0 = f_sub(evals[2], f_add(f_mul(evals[0], evals[0]),
                                        f_mul(evals[1], evals[1])));
  uint32_t num1 = f_mul(f_mul(f_sub(x, g1021), f_sub(x, g1022)), f_sub(x, g1023));
  uint32_t p2 = f_mul(f_mul(num0, num1), f_inv(f_sub(f_pow(x, 1024), 1)));
  uint32_t cp =
      f_add(f_add(f_mul(p0, a0), f_mul(p1, a1)), f_mul(p2, a2));

  // FRI walk
  bool fri_ok = true;
  uint32_t ds = N_EX;
  for (int i = 0; i < N_LAYERS; i++) {
    const Json& L = layers.at(i);
    Digest root = u256_digest(L.at(0));
    uint32_t beta = L.at(1).u32();
    uint32_t cpa = L.at(2).u32(), cpb = L.at(4).u32();
    fri_ok &= (cp == cpa);
    std::vector<Digest> sa, sb;
    for (size_t j = 0; j < L.at(3).size(); j++) sa.push_back(u256_digest(L.at(3).at(j)));
    for (size_t j = 0; j < L.at(5).size(); j++) sb.push_back(u256_digest(L.at(5).at(j)));
    fri_ok &= merkle_check(leaf_m31s({cpa}), idx % ds, sa, root);
    fri_ok &= merkle_check(leaf_m31s({cpb}), (idx + ds / 2) % ds, sb, root);
    uint32_t op0 = f_mul(f_add(cpa, cpb), f_inv(2));
    uint32_t op1 = f_mul(f_sub(cpa, cpb), f_inv(f_mul(2, x)));
    cp = f_add(op0, f_mul(op1, beta));
    x = f_mul(x, x);
    ds /= 2;
  }
  checks.push_back({"fri_walk", fri_ok});
  checks.push_back({"fri_last", cp == last});

  bool all_ok = true;
  for (const Check& c : checks) {
    all_ok &= c.ok;
    std::printf("  %-16s %s\n", c.name, c.ok ? "OK" : "FAIL");
  }
  std::printf("stark101 verdict: %s\n", all_ok ? "ACCEPT" : "REJECT");
  return all_ok ? 0 : 1;
}

static int inspect(const Json& proof) {
  if (proof.has("fri_proof")) {
    const Json& fri = proof.at("fri_proof");
    int n_inner = int(fri.at("inner_layers").size());
    int nq = int(proof.at("config").at("fri_config").at("n_queries").u64());
    size_t hashes = 0;
    hashes += proof.at("decommitments").at(1).at("hash_witness").size();
    hashes += proof.at("decommitments").at(2).at("hash_witness").size();
    hashes += fri.at("first_layer").at("decommitment").at("hash_witness").size();
    for (int l = 0; l < n_inner; l++)
      hashes += fri.at("inner_layers").at(l).at("decommitment").at("hash_witness").size();
    std::printf("stwo proof: queries=%d inner_layers=%d merkle_nodes=%zu\n", nq,
                n_inner, hashes);
    // verifier cost model: SHA-256 compressions per proof
    size_t comp = 0;
    comp += 2 * 3 + 2;                       // stage I mixes + draw
    comp += (hashes + 2ull * nq) * 2;        // merkle pair hashes
    std::printf("est. SHA-256 compressions/verify: ~%zu\n", comp);
  } else {
    std::printf("stark101 proof: layers=%zu\n", proof.at("fri_layers").size());
  }
  return 0;
}

}  // namespace symphony

int main(int argc, char** argv) {
  using namespace symphony;
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: symphony <inspect|verify-stwo|verify-stark101> "
                 "<proof.json> [-v]\n");
    return 2;
  }
  for (int i = 3; i < argc; i++)
    if (std::string(argv[i]) == "-v") g_verbose = true;
  std::ifstream f(argv[2]);
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", argv[2]);
    return 2;
  }
  std::stringstream ss;
  ss << f.rdbuf();
  std::string text = ss.str();
  JsonPtr proof;
  try {
    proof = JsonParser(text).parse();
  } catch (const std::exception& e) {
    std::fprintf(stderr, "json parse error: %s\n", e.what());
    return 2;
  }
  std::string cmd = argv[1];
  if (cmd == "inspect") return inspect(*proof);
  if (cmd == "verify-stwo") return verify_stwo(*proof);
  if (cmd == "verify-stark101") return verify_stark101(*proof);
  std::fprintf(stderr, "unknown command %s\n", cmd.c_str());
  return 2;
}
