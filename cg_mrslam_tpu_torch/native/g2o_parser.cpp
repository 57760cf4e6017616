// Native .g2o text parser: the bulk loader of io/g2o.py (load(native=True)).
//
// Reads VERTEX_SE2, EDGE_SE2, FIX and ROBOTLASER1 lines (g2o's text format,
// as the reference saves its graphs, src/slam/graph_slam.cpp:620-628): one
// pass counts, one pass fills caller-allocated buffers, with no per-line
// Python objects. A malformed line of those four kinds is an error: both
// passes return its 1-based line number, and the caller raises. Any other
// line (comments, CGM_EDGE_META provenance, unknown tags) is skipped here.
// Exposed through ctypes (cg_mrslam_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 g2o_parser.cpp -o libg2o_parser.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Tok {
    char *p;
    char *end;
    Tok(char *line, size_t n) : p(line), end(line + n) {}
    // the next whitespace-separated token [*out, *stop) of the line
    bool next(char **out, char **stop) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= end) return false;
        *out = p;
        while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
        *stop = p;
        return true;
    }
    // a token that is a whole number; false on a missing or partial token
    bool next_d(double *out) {
        char *t, *stop, *e;
        if (!next(&t, &stop)) return false;
        *out = strtod(t, &e);
        return e == stop;
    }
    bool next_ll(long long *out) {
        char *t, *stop, *e;
        if (!next(&t, &stop)) return false;
        *out = strtoll(t, &e, 10);
        return e == stop;
    }
};

struct FileBuf {
    std::vector<char> data;
    bool ok = false;
    explicit FileBuf(const char *path) {
        FILE *f = fopen(path, "rb");
        if (!f) return;
        fseek(f, 0, SEEK_END);
        long n = ftell(f);
        fseek(f, 0, SEEK_SET);
        data.resize((size_t)n + 1);
        ok = n >= 0 && fread(data.data(), 1, (size_t)n, f) == (size_t)n;
        data[(size_t)n] = '\0';
        fclose(f);
    }
};

bool starts(const char *s, const char *tag) {
    return !strncmp(s, tag, strlen(tag));
}

// ROBOTLASER1 payload (g2o robot_laser.cpp field order): type fba fov step
// maxRange accuracy remission beams r[beams] remCount [rem...] laserPose(3)
// odomPose(3) [trailing fields]. `ranges` may be null (count pass).
bool parse_laser(Tok &tok, long long max_beams, long long *beams,
                 double *meta, double *ranges) {
    double type, fba, fov, step, maxr, acc, d;
    long long remis, nrem;
    if (!(tok.next_d(&type) && tok.next_d(&fba) && tok.next_d(&fov) &&
          tok.next_d(&step) && tok.next_d(&maxr) && tok.next_d(&acc) &&
          tok.next_ll(&remis) && tok.next_ll(beams)))
        return false;
    if (*beams < 0 || (ranges && *beams > max_beams)) return false;
    for (long long k = 0; k < *beams; ++k) {
        if (!tok.next_d(&d)) return false;
        if (ranges) ranges[k] = d;
    }
    if (ranges)
        for (long long k = *beams; k < max_beams; ++k) ranges[k] = maxr;
    if (!tok.next_ll(&nrem) || nrem < 0) return false;
    for (long long k = 0; k < nrem; ++k)
        if (!tok.next_d(&d)) return false;
    double pose[6];
    for (int k = 0; k < 6; ++k)
        if (!tok.next_d(&pose[k])) return false;
    if (meta) {
        meta[0] = fba; meta[1] = fov; meta[2] = step; meta[3] = maxr;
        for (int k = 0; k < 6; ++k) meta[4 + k] = pose[k];
    }
    return true;
}

// Walks the file's lines; fills the buffers when `fill` (else counts only).
// Returns 0, -1 when the file cannot be read, or the 1-based number of the
// first malformed line.
long long walk(const char *path, bool fill, long long max_beams,
               long long *nv_out, long long *ne_out, long long *nl_out,
               long long *mb_out, long long *v_ids, double *v_pose,
               uint8_t *v_fixed, long long *e_ids, double *e_z,
               double *e_info, long long *l_vertex, double *l_meta,
               double *l_ranges) {
    FileBuf fb(path);
    if (!fb.ok) return -1;
    long long nv = 0, ne = 0, nl = 0, mb = 0, line = 0;
    std::vector<long long> fixed;  // FIX ids, applied to every vertex after
    char *s = fb.data.data();
    char *end = s + fb.data.size() - 1;
    while (s < end) {
        ++line;
        char *eol = (char *)memchr(s, '\n', (size_t)(end - s));
        if (!eol) eol = end;
        if (starts(s, "VERTEX_SE2 ")) {
            Tok tok(s + 11, (size_t)(eol - s - 11));
            long long id;
            double x, y, th;
            if (!(tok.next_ll(&id) && tok.next_d(&x) && tok.next_d(&y) &&
                  tok.next_d(&th)))
                return line;
            if (fill) {
                v_ids[nv] = id;
                v_pose[3 * nv] = x;
                v_pose[3 * nv + 1] = y;
                v_pose[3 * nv + 2] = th;
                v_fixed[nv] = 0;
            }
            ++nv;
        } else if (starts(s, "EDGE_SE2 ")) {
            Tok tok(s + 9, (size_t)(eol - s - 9));
            long long i, j;
            double vals[9];
            bool ok = tok.next_ll(&i) && tok.next_ll(&j);
            for (int k = 0; ok && k < 9; ++k) ok = tok.next_d(&vals[k]);
            if (!ok) return line;
            if (fill) {
                e_ids[2 * ne] = i;
                e_ids[2 * ne + 1] = j;
                for (int k = 0; k < 3; ++k) e_z[3 * ne + k] = vals[k];
                for (int k = 0; k < 6; ++k) e_info[6 * ne + k] = vals[3 + k];
            }
            ++ne;
        } else if (starts(s, "FIX ")) {
            Tok tok(s + 4, (size_t)(eol - s - 4));
            char *t, *stop, *e;
            while (tok.next(&t, &stop)) {
                long long id = strtoll(t, &e, 10);
                if (e != stop) return line;
                fixed.push_back(id);
            }
        } else if (starts(s, "ROBOTLASER1 ") && nv > 0) {
            // a scan belongs to the vertex before it (one before the first
            // vertex is skipped, as the Python parser skips it)
            Tok tok(s + 12, (size_t)(eol - s - 12));
            long long beams = 0;
            if (!parse_laser(tok, max_beams, &beams,
                             fill ? l_meta + 10 * nl : nullptr,
                             fill ? l_ranges + nl * max_beams : nullptr))
                return line;
            if (fill) l_vertex[nl] = nv - 1;
            if (beams > mb) mb = beams;
            ++nl;
        }
        s = eol + 1;
    }
    if (fill)
        for (long long id : fixed)
            for (long long k = 0; k < nv; ++k)
                if (v_ids[k] == id) v_fixed[k] = 1;
    *nv_out = nv;
    *ne_out = ne;
    *nl_out = nl;
    *mb_out = mb;
    return 0;
}

}  // namespace

extern "C" {

// First pass: counts (max_beams: the longest scan).
long long g2o_count(const char *path, long long *n_vertices,
                    long long *n_edges, long long *n_lasers,
                    long long *max_beams) {
    return walk(path, false, 0, n_vertices, n_edges, n_lasers, max_beams,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr);
}

// Second pass: fill caller-allocated buffers sized by g2o_count.
//   v_ids      [nv]     int64
//   v_pose     [nv*3]   double
//   v_fixed    [nv]     uint8   (from FIX lines)
//   e_ids      [ne*2]   int64
//   e_z        [ne*3]   double
//   e_info     [ne*6]   double  (xx xy xt yy yt tt)
//   l_vertex   [nl]     int64   (index into the vertex arrays)
//   l_meta     [nl*10]  double  (fba fov step maxr laserPose3 odomPose3)
//   l_ranges   [nl*max_beams] double (padded with maxr)
long long g2o_parse(const char *path, long long max_beams, long long *v_ids,
                    double *v_pose, uint8_t *v_fixed, long long *e_ids,
                    double *e_z, double *e_info, long long *l_vertex,
                    double *l_meta, double *l_ranges) {
    long long nv, ne, nl, mb;
    return walk(path, true, max_beams, &nv, &ne, &nl, &mb, v_ids, v_pose,
                v_fixed, e_ids, e_z, e_info, l_vertex, l_meta, l_ranges);
}

}  // extern "C"
