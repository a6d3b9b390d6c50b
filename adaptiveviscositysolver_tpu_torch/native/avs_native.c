/* Native host-side runtime for the adaptive viscosity solver.
 *
 * The reference implements its octree invariant checks and debug geometry
 * export natively (HDK_OctreeGrid.cpp:988-1304 unit tests, cpp:245-308
 * outputOctreeGeometry).  The solver's compute path runs on the device;
 * this module provides the native host-side equivalents (the PyTorch
 * port's copy of the JAX package's module, built apart from it):
 *
 *   - check_octree_invariants(labels): the three debug unit tests (column
 *     consistency, UP-adjacency, ACTIVE grading/reciprocity) over the dense
 *     int8 label pyramid.  ~100x faster than the Python transcription, so
 *     they can run on production-sized grids.
 *   - export_octree_ply(labels, dx, origin, path): ACTIVE cell centers with
 *     per-point scale + level as a binary little-endian PLY point cloud.
 *
 * Pure CPython C API + buffer protocol (no numpy headers needed).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

enum { INACTIVE = 0, ACTIVE = 1, UP = 2, DOWN = 3 };

typedef struct {
    const int8_t *p;
    Py_ssize_t nx, ny, nz;
} Grid;

static inline int8_t at(const Grid *g, Py_ssize_t x, Py_ssize_t y, Py_ssize_t z)
{
    return g->p[(x * g->ny + y) * g->nz + z];
}

static inline int in_bounds(const Grid *g, Py_ssize_t x, Py_ssize_t y, Py_ssize_t z)
{
    return x >= 0 && y >= 0 && z >= 0 && x < g->nx && y < g->ny && z < g->nz;
}

/* Collect the label pyramid out of a Python sequence of buffers. */
static int get_grids(PyObject *seq, Grid *grids, Py_buffer *views, int *n_levels)
{
    Py_ssize_t n = PySequence_Size(seq);
    if (n < 1 || n > 16) {
        PyErr_SetString(PyExc_ValueError, "expected 1..16 label grids");
        return -1;
    }
    *n_levels = (int)n;
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *item = PySequence_GetItem(seq, i);
        int ok = PyObject_GetBuffer(item, &views[i], PyBUF_C_CONTIGUOUS | PyBUF_FORMAT);
        Py_DECREF(item);
        if (ok != 0) {
            for (Py_ssize_t j = 0; j < i; ++j) PyBuffer_Release(&views[j]);
            return -1;
        }
        if (views[i].ndim != 3 || views[i].itemsize != 1) {
            PyErr_SetString(PyExc_ValueError, "label grids must be 3-D int8");
            for (Py_ssize_t j = 0; j <= i; ++j) PyBuffer_Release(&views[j]);
            return -1;
        }
        grids[i].p = (const int8_t *)views[i].buf;
        grids[i].nx = views[i].shape[0];
        grids[i].ny = views[i].shape[1];
        grids[i].nz = views[i].shape[2];
    }
    return 0;
}

#define FAIL(fmt, ...)                                                        \
    do {                                                                      \
        if (PyList_Size(fails) < max_fails) {                                 \
            PyObject *s = PyUnicode_FromFormat(fmt, __VA_ARGS__);             \
            if (s) { PyList_Append(fails, s); Py_DECREF(s); }                 \
        }                                                                     \
    } while (0)

/* getFaceAdjacentCells (HDK_OctreeGrid.cpp:922-978): list of (x,y,z,level)
 * active cells across the face of `cell` in `axis`/`direction`. */
static int face_adjacent_cells(const Grid *g, int levels, int level,
                               Py_ssize_t c[3], int axis, int direction,
                               Py_ssize_t out[4][4])
{
    Py_ssize_t adj[3] = { c[0], c[1], c[2] };
    adj[axis] += direction ? 1 : -1;
    int n = 0;
    int8_t lab = at(&g[level], adj[0], adj[1], adj[2]);
    if (lab == ACTIVE) {
        out[n][0] = adj[0]; out[n][1] = adj[1]; out[n][2] = adj[2];
        out[n][3] = level; ++n;
    } else if (lab == UP) {
        out[n][0] = adj[0] >> 1; out[n][1] = adj[1] >> 1; out[n][2] = adj[2] >> 1;
        out[n][3] = level + 1; ++n;
    } else if (lab == DOWN) {
        for (int s2 = 0; s2 < 2; ++s2)
            for (int s3 = 0; s3 < 2; ++s3) {
                Py_ssize_t ch[3] = { adj[0] * 2, adj[1] * 2, adj[2] * 2 };
                if (!direction) ch[axis] += 1;
                if (s2) ch[(axis + 1) % 3] += 1;
                if (s3) ch[(axis + 2) % 3] += 1;
                if (at(&g[level - 1], ch[0], ch[1], ch[2]) == ACTIVE) {
                    out[n][0] = ch[0]; out[n][1] = ch[1]; out[n][2] = ch[2];
                    out[n][3] = level - 1; ++n;
                }
            }
    }
    return n;
}

static PyObject *check_octree_invariants(PyObject *self, PyObject *args)
{
    PyObject *seq;
    Py_ssize_t max_fails = 16;
    if (!PyArg_ParseTuple(args, "O|n", &seq, &max_fails)) return NULL;

    Grid g[16];
    Py_buffer views[16];
    int levels;
    if (get_grids(seq, g, views, &levels) != 0) return NULL;

    PyObject *fails = PyList_New(0);

    /* 1. column test (activeCountUnitTest, cpp:988-1080) */
    for (Py_ssize_t x = 0; x < g[0].nx; ++x)
        for (Py_ssize_t y = 0; y < g[0].ny; ++y)
            for (Py_ssize_t z = 0; z < g[0].nz; ++z) {
                int8_t v = at(&g[0], x, y, z);
                Py_ssize_t cx = x, cy = y, cz = z;
                int found_down = 0, found_active = 0, bad = 0;
                if (v == DOWN) { FAIL("DOWN at finest level (%zd,%zd,%zd)", x, y, z); continue; }
                for (int l = 1; l < levels && !bad; ++l) {
                    cx >>= 1; cy >>= 1; cz >>= 1;
                    int8_t a = at(&g[l], cx, cy, cz);
                    if (v == INACTIVE) {
                        if (a == DOWN) found_down = 1;
                        else if (a == INACTIVE) { if (found_down) bad = 1; }
                        else bad = 1;
                    } else if (v == ACTIVE) {
                        if (a != DOWN) bad = 1;
                    } else { /* UP */
                        if (a == ACTIVE) { if (found_active) bad = 1; found_active = 1; }
                        else if (a == UP) { if (found_active) bad = 1; }
                        else if (a == DOWN) { if (!found_active) bad = 1; }
                        else bad = 1;
                    }
                }
                if (v == UP && !found_active) bad = 1;
                if (bad) FAIL("column test failed at (%zd,%zd,%zd) label %d", x, y, z, (int)v);
            }

    /* 2. UP adjacency (upAdjacentUnitTest, cpp:1084-1160) */
    for (int l = 0; l < levels && PyList_Size(fails) < max_fails; ++l)
        for (Py_ssize_t x = 0; x < g[l].nx; ++x)
            for (Py_ssize_t y = 0; y < g[l].ny; ++y)
                for (Py_ssize_t z = 0; z < g[l].nz; ++z) {
                    if (at(&g[l], x, y, z) != UP) continue;
                    if (l == levels - 1) { FAIL("UP at top level (%zd,%zd,%zd)", x, y, z); continue; }
                    Py_ssize_t px = (x >> 1) << 1, py = (y >> 1) << 1, pz = (z >> 1) << 1;
                    for (int ci = 0; ci < 8; ++ci) {
                        Py_ssize_t sx = px + (ci & 1), sy = py + ((ci >> 1) & 1), sz = pz + ((ci >> 2) & 1);
                        if (at(&g[l], sx, sy, sz) != UP)
                            FAIL("UP (%zd,%zd,%zd)@%d has non-UP sibling", x, y, z, l);
                    }
                    for (int axis = 0; axis < 3; ++axis)
                        for (int dir = 0; dir < 2; ++dir) {
                            Py_ssize_t a[3] = { x, y, z };
                            a[axis] += dir ? 1 : -1;
                            if (!in_bounds(&g[l], a[0], a[1], a[2])) continue;
                            int8_t al = at(&g[l], a[0], a[1], a[2]);
                            if (al != ACTIVE && al != UP)
                                FAIL("UP (%zd,%zd,%zd)@%d bad neighbour", x, y, z, l);
                        }
                }

    /* 3. ACTIVE grading + reciprocity (activeUnitTest, cpp:1166-1275) */
    for (int l = 0; l < levels && PyList_Size(fails) < max_fails; ++l)
        for (Py_ssize_t x = 0; x < g[l].nx; ++x)
            for (Py_ssize_t y = 0; y < g[l].ny; ++y)
                for (Py_ssize_t z = 0; z < g[l].nz; ++z) {
                    if (at(&g[l], x, y, z) != ACTIVE) continue;
                    Py_ssize_t c[3] = { x, y, z };
                    for (int axis = 0; axis < 3; ++axis)
                        for (int dir = 0; dir < 2; ++dir) {
                            Py_ssize_t a[3] = { x, y, z };
                            a[axis] += dir ? 1 : -1;
                            if (a[axis] < 0 || a[axis] >= (axis == 0 ? g[l].nx : axis == 1 ? g[l].ny : g[l].nz))
                                continue;
                            int8_t al = at(&g[l], a[0], a[1], a[2]);
                            Py_ssize_t adj[4][4];
                            int n = face_adjacent_cells(g, levels, l, c, axis, dir, adj);
                            if (al == DOWN) {
                                if (n != 4) { FAIL("grading: DOWN neighbour of (%zd,%zd,%zd)@%d lacks 4 kids", x, y, z, l); continue; }
                            } else if (al == UP) {
                                if (l == levels - 1 ||
                                    at(&g[l + 1], a[0] >> 1, a[1] >> 1, a[2] >> 1) != ACTIVE)
                                    FAIL("grading: UP neighbour of (%zd,%zd,%zd)@%d parent not ACTIVE", x, y, z, l);
                            }
                            for (int i = 0; i < n; ++i) {
                                Py_ssize_t c2[3] = { adj[i][0], adj[i][1], adj[i][2] };
                                int l2 = (int)adj[i][3];
                                Py_ssize_t rec[4][4];
                                int m = face_adjacent_cells(g, levels, l2, c2, axis, 1 - dir, rec);
                                int found = 0;
                                for (int j = 0; j < m; ++j)
                                    if (rec[j][0] == x && rec[j][1] == y && rec[j][2] == z && rec[j][3] == l)
                                        found = 1;
                                if (!found)
                                    FAIL("reciprocity failed at (%zd,%zd,%zd)@%d", x, y, z, l);
                            }
                        }
                }

    for (int i = 0; i < levels; ++i) PyBuffer_Release(&views[i]);
    return fails;
}

static PyObject *export_octree_ply(PyObject *self, PyObject *args)
{
    PyObject *seq;
    double dx, ox, oy, oz;
    const char *path;
    if (!PyArg_ParseTuple(args, "Od(ddd)s", &seq, &dx, &ox, &oy, &oz, &path))
        return NULL;

    Grid g[16];
    Py_buffer views[16];
    int levels;
    if (get_grids(seq, g, views, &levels) != 0) return NULL;

    long count = 0;
    for (int l = 0; l < levels; ++l) {
        Py_ssize_t n = g[l].nx * g[l].ny * g[l].nz;
        for (Py_ssize_t i = 0; i < n; ++i)
            if (g[l].p[i] == ACTIVE) ++count;
    }

    FILE *f = fopen(path, "wb");
    if (!f) {
        for (int i = 0; i < levels; ++i) PyBuffer_Release(&views[i]);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    fprintf(f,
            "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float pscale\nproperty int octree_level\nend_header\n",
            count);
    for (int l = 0; l < levels; ++l) {
        float scale = (float)(dx * (1 << l));
        for (Py_ssize_t x = 0; x < g[l].nx; ++x)
            for (Py_ssize_t y = 0; y < g[l].ny; ++y)
                for (Py_ssize_t z = 0; z < g[l].nz; ++z)
                    if (at(&g[l], x, y, z) == ACTIVE) {
                        float rec[4] = {
                            (float)(ox + (x + 0.5) * scale),
                            (float)(oy + (y + 0.5) * scale),
                            (float)(oz + (z + 0.5) * scale),
                            scale,
                        };
                        int32_t li = l;
                        fwrite(rec, sizeof(float), 4, f);
                        fwrite(&li, sizeof(int32_t), 1, f);
                    }
    }
    fclose(f);
    for (int i = 0; i < levels; ++i) PyBuffer_Release(&views[i]);
    return PyLong_FromLong(count);
}

static PyMethodDef methods[] = {
    { "check_octree_invariants", check_octree_invariants, METH_VARARGS,
      "check_octree_invariants(labels, max_fails=16) -> list of failure strings" },
    { "export_octree_ply", export_octree_ply, METH_VARARGS,
      "export_octree_ply(labels, dx, (ox,oy,oz), path) -> point count" },
    { NULL, NULL, 0, NULL }
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "avs_native",
    "Native host runtime: octree invariant checks + debug geometry export.",
    -1, methods
};

PyMODINIT_FUNC PyInit_avs_native(void) { return PyModule_Create(&module); }
