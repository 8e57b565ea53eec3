// Single-core CPU baseline emulating the reference cnF2freq per-iteration
// cost structure (cnettel/cnF2freq, cnF2freq.cpp):
//   per individual x shift mode: forward+backward sweeps with dense 64x64
//   xor transitions and per-marker emission recursions (realanalyze,
//   cnF2freq.cpp:2145-2418);
//   per (marker, state, path, shift): posterior probes with per-path
//   emission recursions (doit probe loop, cnF2freq.cpp:5406-5577);
//   per (marker, turn, shift): tail-flip likelihoods
//   (cnF2freq.cpp:5686-5752).
// Fresh implementation of the same algorithm (not copied): a 3-generation
// F2 analysis unit, 64 states, 128 paths, 8 shift modes: a stand-in
// single-core rate where the reference binary itself is not built.
//
// Build: g++ -O3 -march=native -ffast-math -o cpu_baseline cpu_baseline.cc

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <random>
#include <vector>

constexpr int S = 64;       // states
constexpr int PATHS = 128;  // interpretation paths
constexpr int SHIFTS = 8;   // shift modes
constexpr int TURNS = 128;  // flip hypotheses

struct Family {
  // slot 0 focal, 1-2 parents, 3-6 grandparents; [slot][marker][2]
  std::vector<int> md;
  std::vector<double> ms;
  std::vector<double> hw;
  int M;
  int at(int slot, int m, int a) const { return md[(slot * M + m) * 2 + a]; }
  double sure(int slot, int m, int a) const {
    return ms[(slot * M + m) * 2 + a];
  }
  double weight(int slot, int m) const { return hw[slot * M + m]; }
};

// Emission for one (state, path-or-all, shift) via the fixed-depth
// recursion over the family unit (the structure of trackpossible).
static double node_term(const Family& f, int slot, int m, int inval,
                        double sv, int flag, int f2, int shift, int depth) {
  double ok = 0;
  int f2s = (f2 < 0) ? 0 : (f2 & 1);
  int f2e = (f2 < 0) ? 2 : (f2 & 1) + 1;
  for (int r = f2s; r < f2e; r++) {
    int mdv = f.at(slot, m, r);
    double e = f.sure(slot, m, r);
    int bound = inval ? inval : mdv;
    bool miss = inval && mdv && inval != mdv;
    double bv = miss ? e : 1.0 - e;
    double pre = miss ? ((e != 0 && sv != 0) ? (1 - e) * sv : 0)
                      : (mdv ? e : 1.0) * (inval ? sv : (mdv ? 1.0 : 0.0));
    double msn = 0;
    if (depth == 2) {  // top: absorb
      bv += pre;
    } else if (pre != 0 && bv > 0) {
      msn = pre / bv;
    }
    int f2n = r ^ ((flag ^ shift) & 1);
    bool same = f.at(slot, m, 0) == f.at(slot, m, 1) &&
                f.sure(slot, m, 0) == f.sure(slot, m, 1);
    double ph = same ? (double)f2n : std::fabs((double)f2n - f.weight(slot, m));
    bv *= ph;
    if (bv == 0) continue;
    if (depth < 2) {
      int fp = flag & 1;
      int up = flag >> 1;
      int uf2 = f2 < 0 ? -1 : f2 >> 1;
      int base = depth == 0 ? 1 : 3 + 2 * (slot - 1);
      int w = depth == 0 ? 4 : 2;
      int child1, child2, fl1, fl2, p1, p2;
      if (depth == 0) {
        child1 = 1 + fp;      // parent branch order
        child2 = 2 - fp;
        fl1 = (up >> (fp * 3)) & 7;
        fl2 = (up >> ((1 - fp) * 3)) & 7;
        p1 = uf2 < 0 ? -1 : (uf2 >> (fp * 3)) & 7;
        p2 = uf2 < 0 ? -1 : (uf2 >> ((1 - fp) * 3)) & 7;
      } else {
        child1 = 3 + (slot - 1) * 2 + fp;
        child2 = 3 + (slot - 1) * 2 + (1 - fp);
        fl1 = (up >> fp) & 1;
        fl2 = (up >> (1 - fp)) & 1;
        p1 = uf2 < 0 ? -1 : (uf2 >> fp) & 1;
        p2 = uf2 < 0 ? -1 : (uf2 >> (1 - fp)) & 1;
      }
      int sh1 = depth == 0 ? (shift >> 1) & 1 : 0;
      int sh2 = depth == 0 ? (shift >> 2) & 1 : 0;
      double sub1 = node_term(f, child1, m, bound, msn, fl1, p1, sh1,
                              depth + 1);
      double eo = f.sure(slot, m, 1 - r);
      double ss = 0;
      if (eo != 0) { bv *= 1 - eo; ss = eo / (1 - eo); }
      double sub2 = node_term(f, child2, m, f.at(slot, m, 1 - r), ss, fl2,
                              p2, sh2, depth + 1);
      bv *= sub1 * sub2;
    }
    ok += bv;
  }
  return ok;
}

static void emission_all(const Family& f, int m, int shift, double* out) {
  for (int g = 0; g < S; g++)
    out[g] = node_term(f, 0, m, 0, 0, g * 2, -1, shift, 0);
}

static void emission_path(const Family& f, int m, int f2, int shift,
                          double* out) {
  for (int g = 0; g < S; g++)
    out[g] = node_term(f, 0, m, 0, 0, g * 2, f2, shift, 0);
}

int main(int argc, char** argv) {
  int B = argc > 1 ? atoi(argv[1]) : 16;
  int M = argc > 2 ? atoi(argv[2]) : 200;
  std::mt19937 rng(42);
  std::uniform_real_distribution<double> uni(0, 1);

  std::vector<Family> fams(B);
  for (auto& f : fams) {
    f.M = M;
    f.md.resize(7 * M * 2);
    f.ms.resize(7 * M * 2);
    f.hw.resize(7 * M);
    for (int s = 0; s < 7; s++)
      for (int m = 0; m < M; m++) {
        for (int a = 0; a < 2; a++) {
          bool missing = uni(rng) < 0.3 || s == 1 || s == 2;
          f.md[(s * M + m) * 2 + a] = missing ? 0 : 1 + (uni(rng) < 0.5);
          f.ms[(s * M + m) * 2 + a] = missing ? 0.0 : 0.02;
        }
        f.hw[s * M + m] = 0.05 + 0.9 * uni(rng);
      }
  }

  std::vector<double> rec(M - 1);
  for (int i = 0; i < M - 1; i++)
    rec[i] = 0.5 * (1 - std::exp(-0.02 * 1.0));

  auto t0 = std::chrono::steady_clock::now();
  double acc = 0;
  std::vector<double> fw((M + 1) * S), bw((M + 1) * S), e(S), ef(S);

  for (int b = 0; b < B; b++) {
    const Family& f = fams[b];
    for (int shift = 0; shift < SHIFTS; shift++) {
      // forward-backward with dense 64x64 xor transitions
      for (int g = 0; g < S; g++) fw[g] = 1.0 / S;
      for (int m = 0; m < M; m++) {
        emission_all(f, m, shift, e.data());
        double sum = 0;
        for (int g = 0; g < S; g++) { fw[m * S + g] *= e[g]; sum += fw[m * S + g]; }
        double inv = sum > 0 ? 1 / sum : 0;
        for (int g = 0; g < S; g++) fw[m * S + g] *= inv;
        if (m + 1 < M) {
          double r = rec[m];
          double pr[S];
          for (int x = 0; x < S; x++) {
            int pc = __builtin_popcount(x);
            pr[x] = std::pow(r, pc) * std::pow(1 - r, 6 - pc);
          }
          for (int to = 0; to < S; to++) {
            double v = 0;
            for (int from = 0; from < S; from++)
              v += fw[m * S + from] * pr[from ^ to];
            fw[(m + 1) * S + to] = v;
          }
        }
      }
      // backward sweep (same cost structure)
      for (int g = 0; g < S; g++) bw[(M - 1) * S + g] = 1.0;
      for (int m = M - 2; m >= 0; m--) {
        emission_all(f, m + 1, shift, e.data());
        double tmp[S], sum = 0;
        for (int g = 0; g < S; g++) { tmp[g] = bw[(m + 1) * S + g] * e[g]; sum += tmp[g]; }
        double inv = sum > 0 ? 1 / sum : 0;
        double r = rec[m];
        double pr[S];
        for (int x = 0; x < S; x++) {
          int pc = __builtin_popcount(x);
          pr[x] = std::pow(r, pc) * std::pow(1 - r, 6 - pc);
        }
        for (int to = 0; to < S; to++) {
          double v = 0;
          for (int from = 0; from < S; from++)
            v += tmp[from] * inv * pr[from ^ to];
          bw[m * S + to] = v;
        }
      }
      // probe loop: markers x states x canonical paths (32 of 128,
      // matching the reference's flag2ignore pruning for this structure)
      for (int m = 0; m < M; m++) {
        for (int f2 = 0; f2 < PATHS; f2++) {
          if (f2 & 18) continue;
          emission_path(f, m, f2, shift, ef.data());
          for (int g = 0; g < S; g++)
            acc += fw[m * S + g] * ef[g] * bw[m * S + g];
        }
      }
      // turn loop: markers x turns, 64-element dot each
      for (int m = 0; m < M; m++) {
        for (int t = 0; t < TURNS; t++) {
          int ts = t & 54;
          double v = 0;
          for (int g = 0; g < S; g++)
            v += fw[m * S + g] * bw[m * S + (g ^ ts)];
          acc += v;
        }
      }
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  // report individuals*markers per second (one full iteration of work)
  printf("{\"individuals\": %d, \"markers\": %d, \"seconds\": %.3f, "
         "\"ind_markers_per_s\": %.1f, \"check\": %.3e}\n",
         B, M, secs, B * (double)M / secs, acc);
  return 0;
}
