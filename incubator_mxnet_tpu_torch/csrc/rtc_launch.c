/* The host side of one runtime-kernel launch (mx.rtc.CudaKernel.launch), as a
 * CPython extension module, _rtc_launch.
 *
 * Plain C over CPython's API: no CUDA header and no PyTorch header, and no
 * link against the driver.  The driver's entry points arrive as addresses in
 * a "driver table" capsule (driver_table()), taken from the libcuda that
 * Python loaded, so one build serves every driver and a test can hand in
 * stand-ins.  A Python-level ctypes call of cuLaunchKernel converts eleven
 * arguments through their argtypes on every call; here the call is one
 * METH_FASTCALL function.
 *
 *   launch(table, func, ctx, gx, gy, gz, bx, by, bz, shared, stream, params)
 *       Makes ctx current on the calling thread unless it already is (one
 *       cuCtxGetCurrent, a thread-local read in the driver), then calls
 *       cuLaunchKernel with the GIL released.  params is the address of the
 *       kernel's void *[] (the caller packs it; cuLaunchKernel copies the
 *       values before it returns).  Returns None, or (driver call, CUresult)
 *       for the call that failed, so the caller can raise with the kernel's
 *       name.
 *
 *   floor_ns(table, func, ctx, count, stream)
 *       The mean host ns of one cuLaunchKernel of func (no arguments, one
 *       thread) over count launches issued back to back from C: the least a
 *       launch can cost through this driver, with no Python in the loop.
 *       Raises RuntimeError naming the CUresult if a launch fails.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <limits.h>
#include <stdint.h>
#include <time.h>

typedef int CUresult;
typedef void *CUcontext;
typedef CUresult (*launch_fn)(void *func, unsigned gx, unsigned gy,
                              unsigned gz, unsigned bx, unsigned by,
                              unsigned bz, unsigned shared, void *stream,
                              void **params, void **extra);
typedef CUresult (*get_current_fn)(CUcontext *ctx);
typedef CUresult (*set_current_fn)(CUcontext ctx);

typedef struct {
    launch_fn launch;
    get_current_fn get_current;
    set_current_fn set_current;
} driver_table;

static const char TABLE_NAME[] = "_rtc_launch.driver_table";

static void free_table(PyObject *capsule) {
    PyMem_Free(PyCapsule_GetPointer(capsule, TABLE_NAME));
}

static int as_pointer(PyObject *obj, void **out) {
    *out = PyLong_AsVoidPtr(obj);
    return *out == NULL && PyErr_Occurred() ? -1 : 0;
}

static int as_u32(PyObject *obj, unsigned *out) {
    unsigned long v = PyLong_AsUnsignedLong(obj);
    if (v == (unsigned long)-1 && PyErr_Occurred())
        return -1;
    if (v > UINT_MAX) {
        PyErr_Format(PyExc_OverflowError,
                     "launch dimension or shared bytes %lu do not fit in "
                     "32 bits", v);
        return -1;
    }
    *out = (unsigned)v;
    return 0;
}

/* driver_table(cuLaunchKernel, cuCtxGetCurrent, cuCtxSetCurrent): addresses */
static PyObject *make_table(PyObject *self, PyObject *const *args,
                            Py_ssize_t nargs) {
    void *f[3];
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "driver_table takes 3 addresses");
        return NULL;
    }
    for (int i = 0; i < 3; ++i) {
        if (as_pointer(args[i], &f[i]) < 0)
            return NULL;
        if (f[i] == NULL) {
            PyErr_SetString(PyExc_ValueError, "driver_table: null address");
            return NULL;
        }
    }
    driver_table *t = PyMem_Malloc(sizeof(driver_table));
    if (t == NULL)
        return PyErr_NoMemory();
    t->launch = (launch_fn)f[0];
    t->get_current = (get_current_fn)f[1];
    t->set_current = (set_current_fn)f[2];
    PyObject *capsule = PyCapsule_New(t, TABLE_NAME, free_table);
    if (capsule == NULL)
        PyMem_Free(t);
    return capsule;
}

/* Make ctx current on this thread unless it is; 0, or the failing call's
 * CUresult with *what naming it. */
static CUresult bind_context(const driver_table *t, CUcontext ctx,
                             const char **what) {
    CUcontext current = NULL;
    CUresult r = t->get_current(&current);
    if (r != 0) {
        *what = "cuCtxGetCurrent";
        return r;
    }
    if (current != ctx) {
        r = t->set_current(ctx);
        if (r != 0)
            *what = "cuCtxSetCurrent";
    }
    return r;
}

static PyObject *launch(PyObject *self, PyObject *const *args,
                        Py_ssize_t nargs) {
    if (nargs != 12) {
        PyErr_SetString(PyExc_TypeError, "launch takes 12 arguments");
        return NULL;
    }
    const driver_table *t = PyCapsule_GetPointer(args[0], TABLE_NAME);
    if (t == NULL)
        return NULL;
    void *func, *ctx, *stream, *params;
    unsigned dims[7];   /* grid x, y, z, block x, y, z, shared bytes */
    if (as_pointer(args[1], &func) < 0 || as_pointer(args[2], &ctx) < 0)
        return NULL;
    for (int i = 0; i < 7; ++i)
        if (as_u32(args[3 + i], &dims[i]) < 0)
            return NULL;
    if (as_pointer(args[10], &stream) < 0 || as_pointer(args[11], &params) < 0)
        return NULL;
    const char *what = "cuLaunchKernel";
    CUresult r;
    Py_BEGIN_ALLOW_THREADS
    r = bind_context(t, ctx, &what);
    if (r == 0)
        r = t->launch(func, dims[0], dims[1], dims[2], dims[3], dims[4],
                      dims[5], dims[6], stream, (void **)params, NULL);
    Py_END_ALLOW_THREADS
    if (r == 0)
        Py_RETURN_NONE;
    return Py_BuildValue("(si)", what, r);
}

static double now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec * 1e9 + (double)ts.tv_nsec;
}

/* Plain C: mean ns of one launch of func over count launches, or -CUresult
 * of the first that failed. */
double rtc_launch_floor_ns(const driver_table *t, void *func, CUcontext ctx,
                           int count, void *stream) {
    const char *what;
    CUresult r = bind_context(t, ctx, &what);
    if (r != 0)
        return -(double)r;
    double t0 = now_ns();
    for (int i = 0; i < count; ++i) {
        r = t->launch(func, 1, 1, 1, 1, 1, 1, 0, stream, NULL, NULL);
        if (r != 0)
            return -(double)r;
    }
    return (now_ns() - t0) / count;
}

static PyObject *floor_ns(PyObject *self, PyObject *const *args,
                          Py_ssize_t nargs) {
    if (nargs != 5) {
        PyErr_SetString(PyExc_TypeError, "floor_ns takes 5 arguments");
        return NULL;
    }
    const driver_table *t = PyCapsule_GetPointer(args[0], TABLE_NAME);
    if (t == NULL)
        return NULL;
    void *func, *ctx, *stream;
    long count = PyLong_AsLong(args[3]);
    if (as_pointer(args[1], &func) < 0 || as_pointer(args[2], &ctx) < 0 ||
        (count == -1 && PyErr_Occurred()) ||
        as_pointer(args[4], &stream) < 0)
        return NULL;
    if (count < 1 || count > INT_MAX) {
        PyErr_SetString(PyExc_ValueError, "floor_ns: count must be >= 1");
        return NULL;
    }
    double ns;
    Py_BEGIN_ALLOW_THREADS
    ns = rtc_launch_floor_ns(t, func, ctx, (int)count, stream);
    Py_END_ALLOW_THREADS
    if (ns < 0) {
        PyErr_Format(PyExc_RuntimeError, "cuLaunchKernel failed: CUresult %d",
                     (int)-ns);
        return NULL;
    }
    return PyFloat_FromDouble(ns);
}

static PyMethodDef methods[] = {
    {"driver_table", (PyCFunction)(void (*)(void))make_table, METH_FASTCALL,
     "driver_table(cuLaunchKernel, cuCtxGetCurrent, cuCtxSetCurrent)"},
    {"launch", (PyCFunction)(void (*)(void))launch, METH_FASTCALL,
     "launch(table, func, ctx, gx, gy, gz, bx, by, bz, shared, stream, "
     "params) -> None or (driver call, CUresult)"},
    {"floor_ns", (PyCFunction)(void (*)(void))floor_ns, METH_FASTCALL,
     "floor_ns(table, func, ctx, count, stream) -> mean ns of one launch"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_rtc_launch",
    "Host side of a runtime kernel's launch: context, cuLaunchKernel.", -1,
    methods,
};

PyMODINIT_FUNC PyInit__rtc_launch(void) { return PyModule_Create(&module); }
