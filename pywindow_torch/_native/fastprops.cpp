// Native bulk result->properties-dict converter.
//
// CPython extension module (built on first use by
// pywindow_torch.native.fastprops) doing the work of the Python loop of
// pywindow_torch.ops.analysis.to_properties_dicts_bulk_plain: for every
// row of the packed (B, 21 + 6*W) result block (layout:
// ops/analysis.py pack_results) it builds the reference-schema
// properties dict (reference: molecular.py:215-352), the same dicts
// with the same values and dtypes (tests/test_torch_fastprops.py).
// A copy of the JAX package's converter; the sweep's collector thread
// runs it for every chunk.
//
// Array values mirror the numpy implementation exactly:
//   * centre_of_mass / pore_diameter_opt.centre_of_mass are VIEWS of
//     the caller's flat block (base set to the input array, no copy),
//     so the caller passes a block that nothing reuses,
//   * windows.diameters / windows.centre_of_mass are compacted copies
//     of the valid window slots,
// all in the block's own dtype (float32 from the card, float64 on the
// CPU).
//
// Per-frame warnings (refine-failed / negative-diameter) are returned
// as index lists for the Python wrapper to log — logging needs the
// interpreter anyway and both conditions are rare.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// interned dict keys, created once at module init
struct Keys {
    PyObject *centre_of_mass, *maximum_diameter, *diameter, *atom_1,
        *atom_2, *average_diameter, *pore_diameter, *atom, *pore_volume,
        *pore_diameter_opt, *pore_volume_opt, *windows, *diameters,
        *molecular_weight, *cap_saturated, *open_overflow,
        *budget_exceeded;
};
Keys K;

bool init_keys() {
    struct {
        PyObject** slot;
        const char* name;
    } defs[] = {
        {&K.centre_of_mass, "centre_of_mass"},
        {&K.maximum_diameter, "maximum_diameter"},
        {&K.diameter, "diameter"},
        {&K.atom_1, "atom_1"},
        {&K.atom_2, "atom_2"},
        {&K.average_diameter, "average_diameter"},
        {&K.pore_diameter, "pore_diameter"},
        {&K.atom, "atom"},
        {&K.pore_volume, "pore_volume"},
        {&K.pore_diameter_opt, "pore_diameter_opt"},
        {&K.pore_volume_opt, "pore_volume_opt"},
        {&K.windows, "windows"},
        {&K.diameters, "diameters"},
        {&K.molecular_weight, "molecular_weight"},
        {&K.cap_saturated, "_window_cap_saturated"},
        {&K.open_overflow, "_open_cap_overflow"},
        {&K.budget_exceeded, "_opt_budget_exceeded"},
    };
    for (auto& d : defs) {
        *d.slot = PyUnicode_InternFromString(d.name);
        if (*d.slot == nullptr) return false;
    }
    return true;
}

// 1-D / 2-D view into the flat block (no copy; base keeps it alive)
PyObject* block_view(PyArrayObject* flat, char* data, int nd,
                     npy_intp const* dims, npy_intp const* strides) {
    PyArray_Descr* descr = PyArray_DESCR(flat);
    Py_INCREF(descr);
    PyObject* view = PyArray_NewFromDescr(
        &PyArray_Type, descr, nd, const_cast<npy_intp*>(dims),
        const_cast<npy_intp*>(strides), data, NPY_ARRAY_BEHAVED,
        nullptr);
    if (view == nullptr) return nullptr;
    Py_INCREF(flat);
    if (PyArray_SetBaseObject(
            reinterpret_cast<PyArrayObject*>(view),
            reinterpret_cast<PyObject*>(flat)) < 0) {
        Py_DECREF(view);
        return nullptr;
    }
    return view;
}

// set + steal: dict[key] = value (decrefs value; -1 on failure)
int set_steal(PyObject* d, PyObject* key, PyObject* val) {
    if (val == nullptr) return -1;
    int rc = PyDict_SetItem(d, key, val);
    Py_DECREF(val);
    return rc;
}

template <typename T>
PyObject* props_dicts_impl(PyArrayObject* flat, long w) {
    npy_intp b = PyArray_DIM(flat, 0);
    npy_intp cols = PyArray_DIM(flat, 1);
    npy_intp itemsize = PyArray_ITEMSIZE(flat);
    const long off = 21;
    char* base = static_cast<char*>(PyArray_DATA(flat));
    npy_intp rowstride = PyArray_STRIDE(flat, 0);

    PyObject* out = PyList_New(b);
    PyObject* warn_failed = PyList_New(0);
    PyObject* warn_negative = PyList_New(0);
    if (out == nullptr || warn_failed == nullptr ||
        warn_negative == nullptr) {
        Py_XDECREF(out);
        Py_XDECREF(warn_failed);
        Py_XDECREF(warn_negative);
        return nullptr;
    }
    std::vector<npy_intp> keep(static_cast<size_t>(w));

    for (npy_intp i = 0; i < b; ++i) {
        char* rowp = base + i * rowstride;
        const T* row = reinterpret_cast<const T*>(rowp);
        PyObject* props = PyDict_New();
        if (props == nullptr) goto fail;
        PyList_SET_ITEM(out, i, props);  // steals

        // centre_of_mass: view of cols 15:18
        {
            npy_intp d3 = 3;
            PyObject* com = block_view(flat, rowp + 15 * itemsize, 1,
                                       &d3, &itemsize);
            if (set_steal(props, K.centre_of_mass, com) < 0) goto fail;
        }
        // maximum_diameter {diameter, atom_1, atom_2}
        {
            PyObject* d = PyDict_New();
            if (d == nullptr || set_steal(props, K.maximum_diameter, d) < 0)
                goto fail;
            if (set_steal(d, K.diameter,
                          PyFloat_FromDouble(double(row[1]))) < 0 ||
                set_steal(d, K.atom_1,
                          PyLong_FromLong(lround(double(row[7])))) < 0 ||
                set_steal(d, K.atom_2,
                          PyLong_FromLong(lround(double(row[8])))) < 0)
                goto fail;
        }
        if (set_steal(props, K.average_diameter,
                      PyFloat_FromDouble(double(row[2]))) < 0)
            goto fail;
        // pore_diameter {diameter, atom}
        {
            PyObject* d = PyDict_New();
            if (d == nullptr || set_steal(props, K.pore_diameter, d) < 0)
                goto fail;
            if (set_steal(d, K.diameter,
                          PyFloat_FromDouble(double(row[3]))) < 0 ||
                set_steal(d, K.atom,
                          PyLong_FromLong(lround(double(row[9])))) < 0)
                goto fail;
        }
        if (set_steal(props, K.pore_volume,
                      PyFloat_FromDouble(double(row[4]))) < 0)
            goto fail;
        // pore_diameter_opt {diameter, atom_1, centre_of_mass}
        {
            PyObject* d = PyDict_New();
            if (d == nullptr ||
                set_steal(props, K.pore_diameter_opt, d) < 0)
                goto fail;
            npy_intp d3 = 3;
            PyObject* c = block_view(flat, rowp + 18 * itemsize, 1, &d3,
                                     &itemsize);
            if (set_steal(d, K.diameter,
                          PyFloat_FromDouble(double(row[5]))) < 0 ||
                set_steal(d, K.atom_1,
                          PyLong_FromLong(lround(double(row[10])))) < 0 ||
                set_steal(d, K.centre_of_mass, c) < 0)
                goto fail;
        }
        if (set_steal(props, K.pore_volume_opt,
                      PyFloat_FromDouble(double(row[6]))) < 0)
            goto fail;

        // windows
        {
            PyObject* wd = PyDict_New();
            if (wd == nullptr || set_steal(props, K.windows, wd) < 0)
                goto fail;
            bool any_open = double(row[11]) > 0.5;
            if (!any_open) {
                if (PyDict_SetItem(wd, K.diameters, Py_None) < 0 ||
                    PyDict_SetItem(wd, K.centre_of_mass, Py_None) < 0)
                    goto fail;
            } else {
                const T* diam = row + off;
                const T* valid = row + off + w;
                const T* failed = row + off + 2 * w;
                const T* cent = row + off + 3 * w;
                long k = 0;
                bool fail_any = false, neg_any = false;
                for (long j = 0; j < w; ++j) {
                    if (double(failed[j]) > 0.5) fail_any = true;
                    if (double(valid[j]) > 0.5) {
                        if (double(diam[j]) < 0.0) neg_any = true;
                        keep[k++] = j;
                    }
                }
                npy_intp kd[2] = {k, 3};
                PyArray_Descr* descr = PyArray_DESCR(flat);
                Py_INCREF(descr);
                PyObject* darr = PyArray_Empty(1, kd, descr, 0);
                Py_INCREF(descr);
                PyObject* carr = PyArray_Empty(2, kd, descr, 0);
                if (darr == nullptr || carr == nullptr) {
                    Py_XDECREF(darr);
                    Py_XDECREF(carr);
                    goto fail;
                }
                T* dout = static_cast<T*>(
                    PyArray_DATA(reinterpret_cast<PyArrayObject*>(darr)));
                T* cout = static_cast<T*>(
                    PyArray_DATA(reinterpret_cast<PyArrayObject*>(carr)));
                for (long j = 0; j < k; ++j) {
                    npy_intp s = keep[j];
                    dout[j] = diam[s];
                    cout[3 * j] = cent[3 * s];
                    cout[3 * j + 1] = cent[3 * s + 1];
                    cout[3 * j + 2] = cent[3 * s + 2];
                }
                if (set_steal(wd, K.diameters, darr) < 0) {
                    Py_DECREF(carr);
                    goto fail;
                }
                if (set_steal(wd, K.centre_of_mass, carr) < 0) goto fail;
                if (fail_any) {
                    PyObject* idx = PyLong_FromSsize_t(i);
                    if (idx == nullptr ||
                        PyList_Append(warn_failed, idx) < 0) {
                        Py_XDECREF(idx);
                        goto fail;
                    }
                    Py_DECREF(idx);
                }
                if (neg_any) {
                    PyObject* idx = PyLong_FromSsize_t(i);
                    if (idx == nullptr ||
                        PyList_Append(warn_negative, idx) < 0) {
                        Py_XDECREF(idx);
                        goto fail;
                    }
                    Py_DECREF(idx);
                }
            }
        }
        if (set_steal(props, K.molecular_weight,
                      PyFloat_FromDouble(double(row[0]))) < 0)
            goto fail;

        // escalation markers (host entry points pop these; see
        // ops/analysis.py to_properties_dict)
        if (lround(double(row[12])) >= w &&
            PyDict_SetItem(props, K.cap_saturated, Py_True) < 0)
            goto fail;
        if (double(row[13]) > 0.5 &&
            PyDict_SetItem(props, K.open_overflow, Py_True) < 0)
            goto fail;
        if (double(row[14]) > 0.5 &&
            PyDict_SetItem(props, K.budget_exceeded, Py_True) < 0)
            goto fail;
        (void)cols;
    }
    {
        PyObject* result =
            PyTuple_Pack(3, out, warn_failed, warn_negative);
        Py_DECREF(out);
        Py_DECREF(warn_failed);
        Py_DECREF(warn_negative);
        return result;
    }
fail:
    Py_DECREF(out);
    Py_DECREF(warn_failed);
    Py_DECREF(warn_negative);
    return nullptr;
}

PyObject* props_dicts(PyObject*, PyObject* args) {
    PyObject* flat_obj;
    long w;
    if (!PyArg_ParseTuple(args, "Ol", &flat_obj, &w)) return nullptr;
    if (!PyArray_Check(flat_obj)) {
        PyErr_SetString(PyExc_TypeError, "flat must be an ndarray");
        return nullptr;
    }
    PyArrayObject* flat = reinterpret_cast<PyArrayObject*>(flat_obj);
    if (PyArray_NDIM(flat) != 2 ||
        !(PyArray_FLAGS(flat) & NPY_ARRAY_C_CONTIGUOUS)) {
        PyErr_SetString(PyExc_ValueError,
                        "flat must be a C-contiguous 2-D array");
        return nullptr;
    }
    if (PyArray_DIM(flat, 1) < 21 + 6 * w) {
        PyErr_SetString(PyExc_ValueError, "flat has too few columns");
        return nullptr;
    }
    int t = PyArray_TYPE(flat);
    if (t == NPY_FLOAT32) return props_dicts_impl<float>(flat, w);
    if (t == NPY_FLOAT64) return props_dicts_impl<double>(flat, w);
    PyErr_SetString(PyExc_TypeError, "flat must be float32 or float64");
    return nullptr;
}

PyMethodDef methods[] = {
    {"props_dicts", props_dicts, METH_VARARGS,
     "props_dicts(flat, max_windows) -> (dicts, warn_failed_idx, "
     "warn_negative_idx)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_pw_fastprops",
    "native bulk properties-dict converter", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__pw_fastprops() {
    import_array();
    if (!init_keys()) return nullptr;
    return PyModule_Create(&moduledef);
}
