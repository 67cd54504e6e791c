// Native metric kernels for the host-side evaluation loop.
//
// The per-video segment-overlap scores (IoD/IoU, O(segments^2)) and the
// Levenshtein distances (edit score, transcript matching, O(n*m)) run on
// the host every epoch for every test video; in Python they dominate the
// metric-update time.  These are exact ports of the semantics of the
// Python metrics (mucon_tpu_torch/metrics/, which remain the reference and
// the fallback; tests/test_torch_native.py checks equivalence).  The port's
// own copy of mucon_tpu/native/metrics.cpp.
//
// Build: g++ -O3 -shared -fPIC (see mucon_tpu_torch/native/__init__.py).
// Interface: plain C ABI consumed via ctypes — no pybind11 dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Run-length segments of a framewise label sequence.
static void segments_of(const int64_t* y, int n, std::vector<int64_t>& labels,
                        std::vector<int>& starts, std::vector<int>& ends) {
  labels.clear();
  starts.clear();
  ends.clear();
  if (n == 0) return;
  int start = 0;
  for (int i = 1; i <= n; ++i) {
    if (i == n || y[i] != y[i - 1]) {
      labels.push_back(y[i - 1]);
      starts.push_back(start);
      ends.push_back(i);
      start = i;
    }
  }
}

static bool contains(const int64_t* ids, int n, int64_t v) {
  for (int i = 0; i < n; ++i)
    if (ids[i] == v) return true;
  return false;
}

// Best per-GT-segment overlap, averaged over GT segments.
// union_denom = 0 -> IoD (denominator: predicted segment length),
//               1 -> IoU (denominator: union span).
// Returns NaN for videos with no (non-ignored) GT segments, matching the
// Python np.zeros(0).mean() behavior.
double overlap_score(const int64_t* pred, const int64_t* target, int n,
                     const int64_t* ignore, int n_ignore, int union_denom) {
  std::vector<int64_t> t_lab, p_lab;
  std::vector<int> t_s, t_e, p_s, p_e;
  segments_of(target, n, t_lab, t_s, t_e);
  segments_of(pred, n, p_lab, p_s, p_e);

  double total = 0.0;
  int count = 0;
  for (size_t i = 0; i < t_lab.size(); ++i) {
    if (contains(ignore, n_ignore, t_lab[i])) continue;
    double best = 0.0;
    for (size_t j = 0; j < p_lab.size(); ++j) {
      if (contains(ignore, n_ignore, p_lab[j])) continue;
      if (t_lab[i] != p_lab[j]) continue;
      double inter = std::min(p_e[j], t_e[i]) - std::max(p_s[j], t_s[i]);
      double denom = union_denom
                         ? (std::max(p_e[j], t_e[i]) - std::min(p_s[j], t_s[i]))
                         : (p_e[j] - p_s[j]);
      best = std::max(best, inter / denom);
    }
    total += best;
    ++count;
  }
  if (count == 0) return std::nan("");
  return total / count;
}

// Unit-cost Levenshtein distance between integer sequences.
double levenshtein(const int64_t* a, int la, const int64_t* b, int lb) {
  std::vector<double> prev(lb + 1), cur(lb + 1);
  for (int j = 0; j <= lb; ++j) prev[j] = j;
  for (int i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int j = 1; j <= lb; ++j) {
      double sub = prev[j - 1] + (a[i - 1] == b[j - 1] ? 0.0 : 1.0);
      cur[j] = std::min({prev[j] + 1.0, cur[j - 1] + 1.0, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// (distance, max matches among minimal-distance alignments) — the native
// twin of metrics/transcript.py::levenshtein_matches.
void levenshtein_matches(const int64_t* a, int la, const int64_t* b, int lb,
                         int64_t* out_dist, int64_t* out_matches) {
  std::vector<int64_t> pc(lb + 1), cc(lb + 1);  // cost rows
  std::vector<int64_t> pm(lb + 1), cm(lb + 1);  // match rows
  for (int j = 0; j <= lb; ++j) {
    pc[j] = j;
    pm[j] = 0;
  }
  for (int i = 1; i <= la; ++i) {
    cc[0] = i;
    cm[0] = 0;
    for (int j = 1; j <= lb; ++j) {
      bool eq = a[i - 1] == b[j - 1];
      int64_t c_diag = pc[j - 1] + (eq ? 0 : 1);
      int64_t m_diag = pm[j - 1] + (eq ? 1 : 0);
      int64_t c_del = pc[j] + 1, m_del = pm[j];
      int64_t c_ins = cc[j - 1] + 1, m_ins = cm[j - 1];
      // lexicographic min over (cost, -matches)
      int64_t c = c_diag, m = m_diag;
      if (c_del < c || (c_del == c && m_del > m)) { c = c_del; m = m_del; }
      if (c_ins < c || (c_ins == c && m_ins > m)) { c = c_ins; m = m_ins; }
      cc[j] = c;
      cm[j] = m;
    }
    std::swap(pc, cc);
    std::swap(pm, cm);
  }
  *out_dist = pc[lb];
  *out_matches = pm[lb];
}


// Segments with background labels dropped (MS-TCN protocol).
static void segments_bg(const int64_t* y, int n, const int64_t* bg, int nbg,
                        std::vector<int64_t>& labels, std::vector<int>& starts,
                        std::vector<int>& ends) {
  std::vector<int64_t> l;
  std::vector<int> s, e;
  segments_of(y, n, l, s, e);
  labels.clear(); starts.clear(); ends.clear();
  for (size_t i = 0; i < l.size(); ++i) {
    if (contains(bg, nbg, l[i])) continue;
    labels.push_back(l[i]);
    starts.push_back(s[i]);
    ends.push_back(e[i]);
  }
}

// Segmental F1 counts at several IoU thresholds in one pass
// (MS-TCN f_score semantics: per predicted segment, first-argmax IoU over
// ALL GT segments gated by label equality; a GT segment may be hit once per
// threshold).  out is [novl x 3] (tp, fp, fn per threshold).
void f_scores_multi(const int64_t* pred, const int64_t* gt, int n,
                    const int64_t* bg, int nbg,
                    const double* overlaps, int novl, double* out) {
  std::vector<int64_t> p_lab, y_lab;
  std::vector<int> p_s, p_e, y_s, y_e;
  segments_bg(pred, n, bg, nbg, p_lab, p_s, p_e);
  segments_bg(gt, n, bg, nbg, y_lab, y_s, y_e);
  const int np_ = static_cast<int>(p_lab.size());
  const int ny = static_cast<int>(y_lab.size());

  std::vector<char> hits(static_cast<size_t>(ny) * novl, 0);
  std::vector<double> tp(novl, 0.0), fp(novl, 0.0);
  std::vector<double> iou(ny);
  for (int j = 0; j < np_; ++j) {
    int best = 0;
    double best_iou = -1e300;
    for (int i = 0; i < ny; ++i) {
      double inter = std::min(p_e[j], y_e[i]) - std::max(p_s[j], y_s[i]);
      double uni = std::max(p_e[j], y_e[i]) - std::min(p_s[j], y_s[i]);
      double v = (p_lab[j] == y_lab[i]) ? inter / uni : 0.0;
      iou[i] = v;
      if (v > best_iou) { best_iou = v; best = i; }  // first max wins
    }
    for (int s = 0; s < novl; ++s) {
      if (ny > 0 && iou[best] >= overlaps[s] && !hits[best * novl + s]) {
        tp[s] += 1.0;
        hits[best * novl + s] = 1;
      } else {
        fp[s] += 1.0;
      }
    }
  }
  for (int s = 0; s < novl; ++s) {
    double hit_count = 0.0;
    for (int i = 0; i < ny; ++i) hit_count += hits[i * novl + s];
    out[s * 3 + 0] = tp[s];
    out[s * 3 + 1] = fp[s];
    out[s * 3 + 2] = ny - hit_count;
  }
}

// Normalized edit score between bg-dropped segment-label sequences
// ((1 - d/max_len) * 100; empty-vs-empty scores 100).
double edit_score_norm(const int64_t* pred, const int64_t* gt, int n,
                       const int64_t* bg, int nbg) {
  std::vector<int64_t> p_lab, y_lab;
  std::vector<int> p_s, p_e, y_s, y_e;
  segments_bg(pred, n, bg, nbg, p_lab, p_s, p_e);
  segments_bg(gt, n, bg, nbg, y_lab, y_s, y_e);
  int la = static_cast<int>(p_lab.size());
  int lb = static_cast<int>(y_lab.size());
  int m = std::max(la, lb);
  if (m == 0) return 100.0;
  double d = levenshtein(p_lab.data(), la, y_lab.data(), lb);
  return (1.0 - d / m) * 100.0;
}

}  // extern "C"
