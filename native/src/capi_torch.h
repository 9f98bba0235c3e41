/*
 * Build switch for the C shim over the PyTorch port.
 *
 * CMakeLists.txt compiles src/capi.cpp a second time, with this header
 * force-included (-include), into libobj2voxel_tpu_torch.so.  capi.cpp
 * imports its Python API module in one place (api_module); this header
 * sends that import to obj2voxel_tpu_torch.capi: the port's API, whose
 * Instance() takes its device from OBJ2VOXEL_DEVICE (default "cuda"),
 * since a C caller cannot pass one.
 */
#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>

static inline PyObject *o2v_torch_import(const char *name) {
    if (std::strcmp(name, "obj2voxel_tpu.api") == 0) name = "obj2voxel_tpu_torch.capi";
    return PyImport_ImportModule(name);
}

#define PyImport_ImportModule o2v_torch_import
