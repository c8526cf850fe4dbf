// Exact-parity BFS core for periodic molecule reconstruction.
//
// Replaces the per-level Python/numpy frontier expansion of
// pywindow_torch.ops.rebuild.discrete_molecules with a C++ inner loop.
// Semantics are bit-compatible with the validated numpy implementation
// (itself validated against the reference's discrete_molecules,
// reference: utilities.py:820-1085):
//
//   * bond test: rcov_i + rcov_j - tol < d < rcov_i + rcov_j + tol with
//     the 0.1 < d < max_dist prefilter,
//   * terminal atoms are absorbed but never expanded,
//   * per-level discovery order: frontier atoms in order, unit-cell
//     neighbours by ascending index first, then supercell neighbours,
//     first-occurrence dedup by value identity,
//   * supercell images that coincide with a *currently unassigned*
//     unit-cell atom are skipped (they are reached through the unit
//     cell pool),
//   * frontier atoms leave the unassigned pool only after the whole
//     level is processed.
//
// Seed selection and the fractional-COM boundary filter stay on the
// host (numpy) where argmin ties at the 1e-15 level must reproduce
// sklearn/numpy arithmetic bitwise.
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off  (FMA contraction off:
// distance comparisons must match numpy's exact double arithmetic).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <thread>
#include <utility>
#include <vector>
#include <unordered_set>

namespace {

inline double dist3(const double* a, const double* b) {
    const double dx = a[0] - b[0];
    const double dy = a[1] - b[1];
    const double dz = a[2] - b[2];
    // numpy reduces axis -1 as ((x^2 + y^2) + z^2)
    return std::sqrt((dx * dx + dy * dy) + dz * dz);
}

// Fast strtod-compatible float parse for the decoder hot loops.
//
// Handles the overwhelmingly common "[-+]ddd[.ddd][eE[+-]dd]" pattern
// with a single correctly-rounded operation: an exact integer mantissa
// (<= 2^53) multiplied or divided by an exact power of ten (<= 1e22)
// rounds once, which is exactly what a correctly-rounded strtod
// produces — so the fast path is bitwise identical.  Anything else
// (hex floats, inf/nan, 17+ significant digits, |exponent| > 22)
// falls back to std::strtod at the original position.
inline bool parse_double_at(
    const char* text, long len, long& pos, double* out) {
    while (pos < len &&
           (text[pos] == ' ' || text[pos] == '\t' || text[pos] == '\r'))
        ++pos;
    if (pos >= len) return false;
    static const double kPow10[23] = {
        1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
        1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
        1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
    long p = pos;
    bool neg = false;
    if (text[p] == '+' || text[p] == '-') {
        neg = text[p] == '-';
        ++p;
    }
    uint64_t m = 0;
    int n_digits = 0;  // significant digits accumulated into m
    int frac = 0;
    bool any = false, dot = false, too_long = false;
    while (p < len) {
        const char c = text[p];
        if (c >= '0' && c <= '9') {
            if (n_digits < 17) {
                m = m * 10 + static_cast<uint64_t>(c - '0');
                if (m != 0) ++n_digits;
                if (dot) ++frac;
            } else {
                too_long = true;
            }
            any = true;
            ++p;
        } else if (c == '.' && !dot) {
            dot = true;
            ++p;
        } else {
            break;
        }
    }
    if (!any) {  // not a plain number ("inf", hex, garbage)
        char* end = nullptr;
        const double v = std::strtod(text + pos, &end);
        if (end == text + pos) return false;
        *out = v;
        pos = end - text;
        return true;
    }
    int e = 0;
    if (p < len && (text[p] == 'e' || text[p] == 'E')) {
        long q = p + 1;
        bool en = false, has = false;
        if (q < len && (text[q] == '+' || text[q] == '-')) {
            en = text[q] == '-';
            ++q;
        }
        int ev = 0;
        while (q < len && text[q] >= '0' && text[q] <= '9' && ev < 100000) {
            ev = ev * 10 + (text[q] - '0');
            has = true;
            ++q;
        }
        if (has) {  // strtod only consumes the exponent if digits follow
            e = en ? -ev : ev;
            p = q;
        }
    }
    const int net = e - frac;
    if (too_long || m > (1ull << 53) || net < -22 || net > 22) {
        char* end = nullptr;
        const double v = std::strtod(text + pos, &end);
        if (end == text + pos) return false;
        *out = v;
        pos = end - text;
        return true;
    }
    const double mag =
        net >= 0 ? static_cast<double>(m) * kPow10[net]
                 : static_cast<double>(m) / kPow10[-net];
    *out = neg ? -mag : mag;
    pos = p;
    return true;
}

// Uniform bin index of the unit-cell and supercell coordinates: two bin
// grids of one geometry over the bounding box of both sets.  The bin
// edge is at least max_dist * (1 + 1e-4), so every pair closer than
// max_dist lies in the same or adjacent bins; the 27 bins around an
// atom hold every candidate bond partner.  Atoms with a non-finite
// coordinate are left out: their distance to anything fails the
// d < max_dist test.  Within a bin, atoms are in ascending index.
struct BinIndex {
    static constexpr double kMaxBins = 1 << 20;  // caps memory at 16 MiB

    long dims[3] = {1, 1, 1};
    double lo[3] = {0.0, 0.0, 0.0};
    double inv_h = 0.0;  // 0: one bin (a non-finite extent)
    double h = 0.0;
    // per grid: bin b holds items[start[b] .. start[b + 1])
    std::vector<int64_t> start[2], items[2];

    static bool finite3(const double* p) {
        return std::isfinite(p[0]) && std::isfinite(p[1]) &&
               std::isfinite(p[2]);
    }

    long axis_bin(const double* p, int a) const {
        const double t = std::floor((p[a] - lo[a]) * inv_h);
        if (!(t > 0.0)) return 0;
        return t >= static_cast<double>(dims[a] - 1) ? dims[a] - 1
                                                     : static_cast<long>(t);
    }

    long bin_of(const double* p) const {
        return (axis_bin(p, 0) * dims[1] + axis_bin(p, 1)) * dims[2] +
               axis_bin(p, 2);
    }

    BinIndex(long n, const double* coords, long ns, const double* scoords,
             double max_dist) {
        double hi[3] = {0.0, 0.0, 0.0};
        bool any = false;
        for (int g = 0; g < 2; ++g) {
            const long m = g == 0 ? n : ns;
            const double* xyz = g == 0 ? coords : scoords;
            for (long j = 0; j < m; ++j) {
                const double* p = xyz + 3 * j;
                if (!finite3(p)) continue;
                for (int a = 0; a < 3; ++a) {
                    if (!any || p[a] < lo[a]) lo[a] = p[a];
                    if (!any || p[a] > hi[a]) hi[a] = p[a];
                }
                any = true;
            }
        }
        double ext[3];
        bool finite_ext = true;
        for (int a = 0; a < 3; ++a) {
            ext[a] = hi[a] - lo[a];
            finite_ext = finite_ext && std::isfinite(ext[a]);
        }
        h = max_dist * (1.0 + 1e-4);
        if (finite_ext && h > 0.0 && std::isfinite(h)) {
            // a larger bin only adds candidates, so enlarging h to keep
            // a stray far atom from blowing up the grid stays exact
            auto bins = [&](int a) { return std::floor(ext[a] / h) + 1.0; };
            while (bins(0) * bins(1) * bins(2) > kMaxBins) h *= 2.0;
            for (int a = 0; a < 3; ++a) dims[a] = static_cast<long>(bins(a));
            inv_h = 1.0 / h;
        }
        const long nbins = dims[0] * dims[1] * dims[2];
        for (int g = 0; g < 2; ++g) {
            const long m = g == 0 ? n : ns;
            const double* xyz = g == 0 ? coords : scoords;
            std::vector<int64_t> bin(static_cast<size_t>(m), -1);
            start[g].assign(static_cast<size_t>(nbins) + 1, 0);
            for (long j = 0; j < m; ++j) {
                if (!finite3(xyz + 3 * j)) continue;
                bin[j] = bin_of(xyz + 3 * j);
                ++start[g][bin[j] + 1];
            }
            for (long b = 0; b < nbins; ++b) start[g][b + 1] += start[g][b];
            // stable counting sort: ascending index within each bin
            items[g].resize(static_cast<size_t>(start[g][nbins]));
            std::vector<int64_t> fill(start[g].begin(), start[g].end() - 1);
            for (long j = 0; j < m; ++j)
                if (bin[j] >= 0) items[g][fill[bin[j]]++] = j;
        }
    }

    // grid g's atoms in the 27 bins around p, ascending; none for a
    // non-finite p (nothing lies within max_dist of it)
    void candidates(int g, const double* p, std::vector<int64_t>& out) const {
        out.clear();
        if (!finite3(p)) return;
        long b[3];
        for (int a = 0; a < 3; ++a) b[a] = axis_bin(p, a);
        for (long x = std::max(b[0] - 1, 0L);
             x <= std::min(b[0] + 1, dims[0] - 1); ++x)
            for (long y = std::max(b[1] - 1, 0L);
                 y <= std::min(b[1] + 1, dims[1] - 1); ++y)
                for (long z = std::max(b[2] - 1, 0L);
                     z <= std::min(b[2] + 1, dims[2] - 1); ++z) {
                    const long k = (x * dims[1] + y) * dims[2] + z;
                    out.insert(out.end(), items[g].begin() + start[g][k],
                               items[g].begin() + start[g][k + 1]);
                }
        std::sort(out.begin(), out.end());
    }
};

}  // namespace

extern "C" {

// Builds the bin index of one discrete_molecules call (its coordinates
// and max_dist), shared by all of its pw_bfs_molecule calls; free it
// with pw_bin_index_free.  Writes the bins per axis to dims_out and the
// bin edge to edge_out.  Returns null when memory runs out.
void* pw_bin_index_new(long n, const double* coords, long ns,
                       const double* scoords, double max_dist,
                       long* dims_out, double* edge_out) {
    BinIndex* index = nullptr;
    try {
        index = new BinIndex(n, coords, ns, scoords, max_dist);
    } catch (...) {
        return nullptr;
    }
    for (int a = 0; a < 3; ++a) dims_out[a] = index->dims[a];
    *edge_out = index->h;
    return index;
}

void pw_bin_index_free(void* index) { delete static_cast<BinIndex*>(index); }

// Runs one molecule's BFS from `seed`. Returns the number of collected
// entries, or -1 if `cap` is too small. `unassigned` is mutated.
// out_src[k] = 0 (unit cell) / 1 (supercell); out_idx[k] indexes into
// the respective coordinate array.  `index` is pw_bin_index_new's of
// these coordinates; each expanded heavy atom tests only the atoms of
// its 27 bins, in ascending index, so the discovery order is that of a
// scan over all atoms.  The distance tests made are added to *pairs.
long pw_bfs_molecule(
    const void* index,
    long n, const double* coords, const double* cov,
    const uint8_t* heavy, const int64_t* key_id,
    long ns, const double* scoords, const double* scov,
    const uint8_t* sheavy, const int64_t* skey_id,
    const int64_t* s_match_unit,  // unit index with identical value, or -1
    double max_dist, double tol, long seed,
    uint8_t* unassigned,
    int32_t* out_src, int64_t* out_idx, long cap, int64_t* pairs) {
    struct Entry { int32_t src; int64_t idx; };
    const BinIndex& bins = *static_cast<const BinIndex*>(index);

    std::vector<Entry> frontier;
    std::unordered_set<int64_t> in_frontier, in_molecule, next_keys;
    std::vector<Entry> next;
    std::vector<uint8_t> pool(static_cast<size_t>(n));
    std::vector<int64_t> near;
    int64_t tests = 0;

    long count = 0;
    frontier.push_back({0, seed});
    in_frontier.insert(key_id[seed]);
    unassigned[seed] = 0;

    while (!frontier.empty()) {
        // level pool: unassigned atoms plus the current unit-cell frontier
        for (long j = 0; j < n; ++j) pool[j] = unassigned[j];
        for (const auto& e : frontier)
            if (e.src == 0) pool[e.idx] = 1;

        next.clear();
        next_keys.clear();

        for (const auto& e : frontier) {
            if (count >= cap) return -1;
            out_src[count] = e.src;
            out_idx[count] = e.idx;
            ++count;

            const bool is_heavy =
                e.src == 0 ? heavy[e.idx] != 0 : sheavy[e.idx] != 0;
            if (!is_heavy) continue;

            const double* pos =
                e.src == 0 ? coords + 3 * e.idx : scoords + 3 * e.idx;
            const double rc = e.src == 0 ? cov[e.idx] : scov[e.idx];

            // unit-cell neighbours, ascending index
            bins.candidates(0, pos, near);
            for (const int64_t j : near) {
                if (!pool[j]) continue;
                if (e.src == 0 && j == e.idx) continue;
                ++tests;
                const double d = dist3(pos, coords + 3 * j);
                if (!(d > 0.1) || !(d < max_dist)) continue;
                const double rcv = rc + cov[j];
                if (rcv - tol < d && d < rcv + tol) {
                    const int64_t k = key_id[j];
                    if (!in_frontier.count(k) && !next_keys.count(k)) {
                        next.push_back({0, j});
                        next_keys.insert(k);
                    }
                }
            }
            // supercell neighbours, ascending index
            bins.candidates(1, pos, near);
            for (const int64_t j : near) {
                ++tests;
                const double d = dist3(pos, scoords + 3 * j);
                if (!(d > 0.1) || !(d < max_dist)) continue;
                const double rcv = rc + scov[j];
                if (!(rcv - tol < d && d < rcv + tol)) continue;
                const int64_t m = s_match_unit[j];
                if (m >= 0 && unassigned[m]) continue;
                const int64_t k = skey_id[j];
                if (!in_frontier.count(k) && !next_keys.count(k) &&
                    !in_molecule.count(k)) {
                    next.push_back({1, j});
                    next_keys.insert(k);
                }
            }
        }

        for (const auto& e : frontier) {
            in_molecule.insert(e.src == 0 ? key_id[e.idx]
                                          : skey_id[e.idx]);
            if (e.src == 0) unassigned[e.idx] = 0;
        }

        frontier.clear();
        in_frontier.clear();
        for (const auto& e : next) {
            const int64_t k = e.src == 0 ? key_id[e.idx] : skey_id[e.idx];
            if (in_molecule.count(k)) continue;
            frontier.push_back(e);
            in_frontier.insert(k);
            if (e.src == 0) unassigned[e.idx] = 0;
        }
    }
    *pairs += tests;
    return count;
}

// Fast frame decoder for DL_POLY HISTORY text blocks.
// Parses `text[0:len]` holding one frame (starting at its "timestep"
// line). Writes atom-id string offsets and coordinates. Returns the
// number of atoms, or -1 on parse error.
long pw_decode_dlpoly_frame(
    const char* text, long len, long keytrj, long has_cell,
    double* cell /*9, column lattice vectors as rows in file order*/,
    char* ids /*natoms * 9, zero-padded*/, double* xyz /*natoms * 3*/,
    double* vel /*natoms * 3 when keytrj >= 1, else may be null*/,
    double* frc /*natoms * 3 when keytrj == 2, else may be null*/,
    long cap_atoms) {
    long pos = 0;
    auto skip_ws = [&]() {
        while (pos < len &&
               (text[pos] == ' ' || text[pos] == '\t' ||
                text[pos] == '\r'))
            ++pos;
    };
    auto next_line = [&]() {
        // memchr (SIMD) instead of a byte loop: the scan past each
        // record/coordinate line's trailing columns was ~30% of the
        // whole-sweep decode on the single host core.
        const char* nl = static_cast<const char*>(std::memchr(
            text + pos, '\n', static_cast<size_t>(len - pos)));
        pos = nl ? (nl - text) + 1 : len;
    };
    auto parse_double = [&](double* out) -> bool {
        // fast correctly-rounded path, strtod fallback (bitwise equal)
        return parse_double_at(text, len, pos, out);
    };

    next_line();  // timestep line (already validated by the mapper)
    if (has_cell) {
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c)
                if (!parse_double(cell + 3 * r + c)) return -1;
            next_line();
        }
    }
    long atom = 0;
    while (pos < len) {
        skip_ws();
        if (pos >= len || text[pos] == '\n') break;
        if (atom >= cap_atoms) return -1;
        // record line: name  index  mass  charge
        long w0 = pos;
        while (pos < len && text[pos] != ' ' && text[pos] != '\t' &&
               text[pos] != '\n')
            ++pos;
        long wlen = pos - w0;
        if (wlen > 8) wlen = 8;
        for (long k = 0; k < 9; ++k)
            ids[atom * 9 + k] = k < wlen ? text[w0 + k] : '\0';
        next_line();
        // coordinates line
        double x, y, z;
        if (!parse_double(&x) || !parse_double(&y) || !parse_double(&z))
            return -1;
        xyz[atom * 3 + 0] = x;
        xyz[atom * 3 + 1] = y;
        xyz[atom * 3 + 2] = z;
        next_line();
        // velocity / force lines (parsed when an output buffer is
        // given, skipped otherwise)
        for (long s = 0; s < keytrj; ++s) {
            double* out3 = s == 0 ? vel : frc;
            if (out3 != nullptr) {
                double a, b, c;
                if (!parse_double(&a) || !parse_double(&b) ||
                    !parse_double(&c))
                    return -1;
                out3[atom * 3 + 0] = a;
                out3[atom * 3 + 1] = b;
                out3[atom * 3 + 2] = c;
            }
            next_line();
        }
        ++atom;
    }
    return atom;
}

// XYZ trajectory frame decoder: line 1 = atom count, line 2 = remark,
// then "name x y z" per atom.  Returns atoms parsed or -1 on error.
long pw_decode_xyz_frame(
    const char* text, long len,
    char* ids /*cap * 9, zero-padded*/, double* xyz /*cap * 3*/,
    long cap_atoms) {
    long pos = 0;
    auto next_line = [&]() {
        const char* nl = static_cast<const char*>(std::memchr(
            text + pos, '\n', static_cast<size_t>(len - pos)));
        pos = nl ? (nl - text) + 1 : len;
    };
    auto skip_ws = [&]() {
        while (pos < len &&
               (text[pos] == ' ' || text[pos] == '\t' ||
                text[pos] == '\r'))
            ++pos;
    };
    auto parse_double = [&](double* out) -> bool {
        // fast correctly-rounded path, strtod fallback (bitwise equal)
        return parse_double_at(text, len, pos, out);
    };
    next_line();  // atom count (validated by the mapper)
    next_line();  // remark
    long atom = 0;
    while (pos < len) {
        skip_ws();
        if (pos >= len || text[pos] == '\n') {
            next_line();
            continue;
        }
        if (atom >= cap_atoms) return -1;
        long w0 = pos;
        while (pos < len && text[pos] != ' ' && text[pos] != '\t' &&
               text[pos] != '\n')
            ++pos;
        long wlen = pos - w0;
        if (wlen > 8) wlen = 8;
        for (long k = 0; k < 9; ++k)
            ids[atom * 9 + k] = k < wlen ? text[w0 + k] : '\0';
        double x, y, z;
        if (!parse_double(&x) || !parse_double(&y) || !parse_double(&z))
            return -1;
        xyz[atom * 3 + 0] = x;
        xyz[atom * 3 + 1] = y;
        xyz[atom * 3 + 2] = z;
        next_line();
        ++atom;
    }
    return atom;
}

// PDB trajectory frame decoder: fixed-column ATOM/HETATM records
// (atom name cols 13-16, coordinates cols 31-54) plus the CRYST1 cell
// (a,b,c,alpha,beta,gamma).  Returns atoms parsed or -1 on error;
// *has_cryst is set when a non-zero CRYST1 was found.
long pw_decode_pdb_frame(
    const char* text, long len,
    char* ids /*cap * 9*/, double* xyz /*cap * 3*/,
    double* cryst /*6*/, long* has_cryst, long cap_atoms) {
    long pos = 0;
    *has_cryst = 0;
    auto fixed_double = [&](long start, long width, double* out) -> bool {
        char buf[16];
        if (width > 15) return false;
        for (long k = 0; k < width; ++k) {
            char c = (pos + start + k < len) ? text[pos + start + k] : ' ';
            buf[k] = (c == '\n') ? ' ' : c;
        }
        buf[width] = '\0';
        char* end = nullptr;
        *out = std::strtod(buf, &end);
        return end != buf;
    };
    long atom = 0;
    while (pos < len) {
        const char* nl = static_cast<const char*>(std::memchr(
            text + pos, '\n', static_cast<size_t>(len - pos)));
        long line_len = nl ? (nl - text) - pos : len - pos;
        if (line_len >= 6) {
            bool is_atom =
                std::strncmp(text + pos, "HETATM", 6) == 0 ||
                std::strncmp(text + pos, "ATOM  ", 6) == 0;
            if (is_atom) {
                if (atom >= cap_atoms || line_len < 54) return -1;
                // atom name: cols 12..15, stripped
                long s = 12, e = 16;
                while (s < e && text[pos + s] == ' ') ++s;
                while (e > s && text[pos + e - 1] == ' ') --e;
                long wlen = e - s;
                if (wlen > 8) wlen = 8;
                for (long k = 0; k < 9; ++k)
                    ids[atom * 9 + k] =
                        k < wlen ? text[pos + s + k] : '\0';
                double x, y, z;
                if (!fixed_double(30, 8, &x) || !fixed_double(38, 8, &y) ||
                    !fixed_double(46, 8, &z))
                    return -1;
                xyz[atom * 3 + 0] = x;
                xyz[atom * 3 + 1] = y;
                xyz[atom * 3 + 2] = z;
                ++atom;
            } else if (std::strncmp(text + pos, "CRYST1", 6) == 0 &&
                       line_len >= 54) {
                double v[6];
                bool ok = fixed_double(6, 9, &v[0]) &&
                          fixed_double(15, 9, &v[1]) &&
                          fixed_double(24, 9, &v[2]) &&
                          fixed_double(33, 7, &v[3]) &&
                          fixed_double(40, 7, &v[4]) &&
                          fixed_double(47, 7, &v[5]);
                if (ok && v[0] + v[1] + v[2] != 0.0) {
                    for (int k = 0; k < 6; ++k) cryst[k] = v[k];
                    *has_cryst = 1;
                }
            }
        }
        pos += line_len;
        if (pos < len) ++pos;  // consume newline
    }
    return atom;
}

// ---------------------------------------------------------------------------
// Trajectory sweep fast path: one-pass HISTORY map/integrity-check and
// multithreaded whole-sweep frame decoding.  These feed the device
// batch pipeline directly (trajectory.analysis_batched), replacing the
// per-frame Python decode that dominated end-to-end sweep time.
// Semantics mirror the Python implementations in
// pywindow_torch/trajectory.py (themselves mirroring reference
// trajectory.py:647-833); the Python paths remain as the plain versions.

// Map a DL_POLY HISTORY buffer: frame byte ranges, header end, header
// warnings, and the reference's integrity checks (empty lines,
// monotone timesteps — reference: trajectory.py:768-833).
// Returns n_frames, or -1 empty line (err_line set), -2 discontinuous
// trajectory (err_line set), -3 capacity exceeded.
// warn_flags: bit0 = line 1 lacks the DLFIELD comment header,
//             bit1 = line 2 is not the 3-field periodicity header.
long pw_map_history(
    const char* text, long len,
    int64_t* starts, int64_t* ends, long cap,
    int64_t* header_end, int64_t* warn_flags, int64_t* err_line) {
    *warn_flags = 0;
    *err_line = 0;
    *header_end = 0;
    long pos = 0;
    long line_no = 0;
    long n_frames = 0;
    long frame_start = 0;
    bool header_done = false;
    long long prev_ts = 0;
    while (pos < len) {
        long line_start = pos;
        const char* nl = static_cast<const char*>(
            std::memchr(text + pos, '\n', static_cast<size_t>(len - pos)));
        long line_end = nl ? (nl - text) : len;
        ++line_no;
        // fast path: a data line (atom record / coordinates) needs NO
        // token work — only empty-line detection and the "timestep"
        // test.  One first-byte classification (plus a short ws skip
        // for space-led coordinate lines) replaces the full token
        // scans that made the map pass ~45% of the decode cost.
        if (line_no > 2) {
            const char c0 =
                line_start < line_end ? text[line_start] : '\n';
            if (c0 != 't' && c0 != ' ' && c0 != '\t' && c0 != '\r' &&
                line_start != line_end) {
                pos = nl ? (line_end + 1) : len;
                continue;
            }
            long t = line_start;
            while (t < line_end &&
                   (text[t] == ' ' || text[t] == '\t' ||
                    text[t] == '\r'))
                ++t;
            if (t == line_end) {  // empty/whitespace line -> hard error
                *err_line = line_no;
                return -1;
            }
            // exact first-token == "timestep" (token must END at +8)
            if (text[t] == 't' && line_end - t >= 8 &&
                std::strncmp(text + t, "timestep", 8) == 0 &&
                (t + 8 == line_end || text[t + 8] == ' ' ||
                 text[t + 8] == '\t' || text[t + 8] == '\r')) {
                char* end = nullptr;
                long long ts = std::strtoll(text + t + 8, &end, 10);
                if (end != text + t + 8) {
                    if (prev_ts > ts) {
                        *err_line = line_no;
                        return -2;
                    }
                    prev_ts = ts;
                }
                if (header_done) {
                    if (n_frames >= cap) return -3;
                    starts[n_frames] = frame_start;
                    ends[n_frames] = line_start;
                    ++n_frames;
                } else {
                    *header_end = line_start;
                    header_done = true;
                }
                frame_start = line_start;
            }
            pos = nl ? (line_end + 1) : len;
            continue;
        }
        // header lines 1-2: full token work (once per file)
        long t = line_start;
        while (t < line_end &&
               (text[t] == ' ' || text[t] == '\t' || text[t] == '\r'))
            ++t;
        if (t == line_end) {  // empty line -> hard error
            *err_line = line_no;
            return -1;
        }
        long te = t;
        while (te < line_end && text[te] != ' ' && text[te] != '\t' &&
               text[te] != '\r')
            ++te;
        if (line_no == 1) {
            if (te - t != 7 || std::strncmp(text + t, "DLFIELD", 7) != 0)
                *warn_flags |= 1;
        } else if (line_no == 2) {
            // count whitespace-separated fields
            long fields = 0;
            long q = line_start;
            while (q < line_end) {
                while (q < line_end &&
                       (text[q] == ' ' || text[q] == '\t' ||
                        text[q] == '\r'))
                    ++q;
                if (q == line_end) break;
                ++fields;
                while (q < line_end && text[q] != ' ' &&
                       text[q] != '\t' && text[q] != '\r')
                    ++q;
            }
            if (fields != 3) *warn_flags |= 2;
        }
        if (te - t == 8 && std::strncmp(text + t, "timestep", 8) == 0) {
            char* end = nullptr;
            long long ts = std::strtoll(text + te, &end, 10);
            if (end != text + te) {
                if (prev_ts > ts) {
                    *err_line = line_no;
                    return -2;
                }
                prev_ts = ts;
            }
            if (header_done) {
                if (n_frames >= cap) return -3;
                starts[n_frames] = frame_start;
                ends[n_frames] = line_start;
                ++n_frames;
            } else {
                *header_end = line_start;
                header_done = true;
            }
            frame_start = line_start;
        }
        pos = nl ? (line_end + 1) : len;
    }
    if (header_done) {
        if (n_frames >= cap) return -3;
        starts[n_frames] = frame_start;
        ends[n_frames] = len;
        ++n_frames;
    }
    return n_frames;
}

}  // extern "C"

namespace {

// vdW-corrected maximum diameter of one frame, bitwise-matching the
// host numpy scan in ops/analysis.py::max_dim_host: per pair (i, j)
// the value is ((sqrt((dx*dx+dy*dy)+dz*dz) + vdw_i) + vdw_j); numpy
// maxes over the FULL matrix (both orderings of each pair), so both
// are evaluated here too (ulp-level addition-order differences).
double frame_max_dim(const double* xyz, const double* vdw, long n) {
    // Exact vdW-corrected maximum diameter with triangle-inequality
    // pruning: the O(N^2) scan dominated single-core sweep decode.
    // Sort atoms by centroid distance + radius descending; any pair
    // whose bound s_i + s_j (+ margin for the bound's own rounding)
    // cannot beat the current best is skipped — and the sort order
    // makes every remaining j in the inner loop skippable too.  The
    // winning pair is always evaluated with the exact same expression
    // as the full scan (both operand orders, as the full i x j loop
    // visits each pair twice), so the result is bitwise identical.
    if (n <= 0) return 0.0;
    double c[3] = {0.0, 0.0, 0.0};
    for (long i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) c[k] += xyz[3 * i + k];
    for (int k = 0; k < 3; ++k) c[k] /= static_cast<double>(n);
    std::vector<std::pair<double, long>> order(
        static_cast<size_t>(n));
    for (long i = 0; i < n; ++i)
        order[i] = {-(dist3(xyz + 3 * i, c) + vdw[i]), i};
    std::sort(order.begin(), order.end());
    const double margin = 1e-7;  // >> double rounding at Angstrom scale
    double best = 0.0;
    for (long a = 0; a < n; ++a) {
        const double si = -order[a].first;
        if (si + si + margin <= best) break;  // nothing below can win
        const long i = order[a].second;
        const double* A = xyz + 3 * i;
        const double vi = vdw[i];
        for (long b = a; b < n; ++b) {
            const double sj = -order[b].first;
            if (si + sj + margin <= best) break;  // sorted: rest worse
            const long j = order[b].second;
            const double dd = dist3(A, xyz + 3 * j);
            const double d1 = (dd + vi) + vdw[j];
            if (d1 > best) best = d1;
            const double d2 = (dd + vdw[j]) + vi;
            if (d2 > best) best = d2;
        }
    }
    return best;
}

// Generic multithreaded batch decode driver.  DecodeFn decodes one
// frame into (ids_scratch, xyz_out) and returns the atom count (or -1).
template <typename DecodeFn>
long batch_decode(
    const char* text, const int64_t* starts, const int64_t* ends,
    long n_frames, long n_atoms, const char* ref_ids, double* xyz,
    float* xyz32, const double* vdw, double* maxd, long n_threads,
    int64_t* ids_match, DecodeFn decode_one) {
    if (xyz == nullptr && xyz32 == nullptr) return -1;  // no output sink
    std::atomic<long> first_fail(-1);
    std::atomic<bool> all_ids_match(true);
    if (n_threads < 1) n_threads = 1;
    long hw = static_cast<long>(std::thread::hardware_concurrency());
    if (hw > 0 && n_threads > hw) n_threads = hw;
    if (n_threads > n_frames) n_threads = n_frames;
    if (n_threads < 1) n_threads = 1;

    auto worker = [&](long lo, long hi) {
        std::vector<char> ids(static_cast<size_t>(n_atoms) * 9);
        // xyz == nullptr: f32-only mode — parse into a one-frame
        // L1-resident scratch instead of streaming a full (F, N, 3)
        // f64 block through the cache (the sweep's f32 pipeline never
        // reads the f64 store; skipping it halves the decode's memory
        // writes and drops the per-slab 17 MB allocation).
        std::vector<double> scratch(
            xyz == nullptr ? static_cast<size_t>(n_atoms) * 3 : 0);
        bool local_match = true;
        for (long i = lo; i < hi; ++i) {
            if (first_fail.load(std::memory_order_relaxed) >= 0) return;
            double* frame_xyz =
                xyz != nullptr
                    ? xyz + static_cast<size_t>(i) * n_atoms * 3
                    : scratch.data();
            long got = decode_one(
                text + starts[i], ends[i] - starts[i], ids.data(),
                frame_xyz);
            if (got != n_atoms) {
                long expected = -1;
                first_fail.compare_exchange_strong(expected, i);
                return;
            }
            if (local_match &&
                std::memcmp(ids.data(), ref_ids,
                            static_cast<size_t>(n_atoms) * 9) != 0)
                local_match = false;
            if (vdw != nullptr && maxd != nullptr)
                maxd[i] = frame_max_dim(frame_xyz, vdw, n_atoms);
            if (xyz32 != nullptr) {
                // fused f64 -> f32 while the frame is cache-hot: saves
                // the pipeline's separate (F, N, 3) conversion pass
                // (numpy astype and this cast are both round-to-
                // nearest-even — bitwise identical)
                float* f = xyz32 + static_cast<size_t>(i) * n_atoms * 3;
                for (long k = 0; k < n_atoms * 3; ++k)
                    f[k] = static_cast<float>(frame_xyz[k]);
            }
        }
        if (!local_match) all_ids_match.store(false);
    };

    if (n_threads == 1) {
        worker(0, n_frames);
    } else {
        std::vector<std::thread> pool;
        long per = (n_frames + n_threads - 1) / n_threads;
        for (long k = 0; k < n_threads; ++k) {
            long lo = k * per;
            long hi = lo + per < n_frames ? lo + per : n_frames;
            if (lo >= hi) break;
            pool.emplace_back(worker, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    *ids_match = all_ids_match.load() ? 1 : 0;
    long fail = first_fail.load();
    return fail >= 0 ? -(fail + 1) : 0;
}

}  // namespace

extern "C" {

// Decode every frame of a DL_POLY sweep into one (F, N, 3) block.
// ref_ids: frame-0 atom ids (n_atoms * 9, from pw_decode_dlpoly_frame);
// *ids_match reports whether every frame's ids equal ref_ids (the fast
// path precondition for sharing one deciphered element array).
// When vdw (n_atoms, post-decipher radii) and maxd (n_frames) are
// non-null, each frame's exact vdW-corrected maximum diameter is also
// computed (f64, bitwise equal to the host numpy scan) — it pins the
// sweep's sampling sizes without a second pass.
// Returns 0, or -(i+1) if frame i failed to parse / had a different
// atom count.  Runs on n_threads std::threads (the ctypes call site
// releases the GIL, so decode overlaps Python and device work).
long pw_decode_dlpoly_frames_batch(
    const char* text, const int64_t* starts, const int64_t* ends,
    long n_frames, long keytrj, long has_cell, long n_atoms,
    const char* ref_ids, double* xyz, float* xyz32, const double* vdw,
    double* maxd, long n_threads, int64_t* ids_match) {
    return batch_decode(
        text, starts, ends, n_frames, n_atoms, ref_ids, xyz, xyz32,
        vdw, maxd, n_threads, ids_match,
        [keytrj, has_cell, n_atoms](const char* t, long l, char* ids,
                                    double* out) {
            double cell[9];
            return pw_decode_dlpoly_frame(
                t, l, keytrj, has_cell, cell, ids, out, nullptr, nullptr,
                n_atoms);
        });
}

// XYZ-trajectory analog of pw_decode_dlpoly_frames_batch.
long pw_decode_xyz_frames_batch(
    const char* text, const int64_t* starts, const int64_t* ends,
    long n_frames, long n_atoms, const char* ref_ids, double* xyz,
    float* xyz32, const double* vdw, double* maxd, long n_threads,
    int64_t* ids_match) {
    return batch_decode(
        text, starts, ends, n_frames, n_atoms, ref_ids, xyz, xyz32,
        vdw, maxd, n_threads, ids_match,
        [n_atoms](const char* t, long l, char* ids, double* out) {
            return pw_decode_xyz_frame(t, l, ids, out, n_atoms);
        });
}

// PDB-trajectory analog of pw_decode_dlpoly_frames_batch (per-frame
// CRYST1 records are ignored: the fast sweep path analyses molecules,
// not periodic cells — frames needing rebuild use the generic path).
long pw_decode_pdb_frames_batch(
    const char* text, const int64_t* starts, const int64_t* ends,
    long n_frames, long n_atoms, const char* ref_ids, double* xyz,
    float* xyz32, const double* vdw, double* maxd, long n_threads,
    int64_t* ids_match) {
    return batch_decode(
        text, starts, ends, n_frames, n_atoms, ref_ids, xyz, xyz32,
        vdw, maxd, n_threads, ids_match,
        [n_atoms](const char* t, long l, char* ids, double* out) {
            double cryst[6];
            long has_cryst = 0;
            return pw_decode_pdb_frame(t, l, ids, out, cryst,
                                       &has_cryst, n_atoms);
        });
}

}  // extern "C"
