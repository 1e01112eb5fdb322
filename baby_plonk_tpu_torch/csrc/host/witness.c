/* Native reader of round 1's witness (baby_plonk_tpu_torch/protocol/
 * program.py::WireTable.packed): one pass over a witness dict in the dict's
 * own insertion order. Each key is checked against the key order the table
 * learned, and each value is written as 32 little-endian bytes, reduced
 * below the field's modulus, into its slot of the table's variable order.
 *
 * Built apart from the Keccak helper, against Python's headers, and bound
 * with ctypes.PyDLL (baby_plonk_tpu_torch/native.py), so the GIL is held
 * throughout. The pass calls no Python code and creates no object.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* v (an int) as 32 little-endian bytes at out: 0, or -1 with the error
 * cleared where v is negative or at least 2^256. */
static int as_bytes32(PyObject *v, uint8_t *out) {
#if PY_VERSION_HEX >= 0x030D0000
    Py_ssize_t need = PyLong_AsNativeBytes(
        v, out, 32,
        Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER |
            Py_ASNATIVEBYTES_REJECT_NEGATIVE);
    if (need < 0) {
        PyErr_Clear();
        return -1;
    }
    return need <= 32 ? 0 : -1;
#else
    if (_PyLong_AsByteArray((PyLongObject *)v, out, 32, 1, 0) < 0) {
        PyErr_Clear();
        return -1;
    }
    return 0;
#endif
}

/* x < 2^256 < 3 q, so at most two subtractions of q bring it below q. */
static void reduce(uint8_t *bytes, const uint64_t q[4]) {
    uint64_t x[4];
    memcpy(x, bytes, 32);
    for (int t = 0; t < 2; t++) {
        int below = 0;
        for (int i = 3; i >= 0; i--) {
            if (x[i] != q[i]) {
                below = x[i] < q[i];
                break;
            }
        }
        if (below)
            break;
        unsigned __int128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            unsigned __int128 d = (unsigned __int128)x[i] - q[i] - borrow;
            x[i] = (uint64_t)d;
            borrow = (d >> 64) & 1;
        }
    }
    memcpy(bytes, x, 32);
}

static int same_key(PyObject *key, PyObject *want) {
    if (key == want)
        return 1;
    if (!PyUnicode_CheckExact(key) || !PyUnicode_CheckExact(want))
        return 0;
    return PyObject_Hash(key) == PyObject_Hash(want) && PyUnicode_Compare(key, want) == 0;
}

/* witness: a dict; keys: the learned key order, a list of str; slots[i]:
 * the position in the table's variable order of keys[i]'s value, or -1
 * where no wire reads it; q: the modulus as 4 little-endian words; out: 32
 * bytes a position; flagged: room for one int32 a position.
 *
 * Returns -1 (a miss: out holds nothing usable) where the dict's size or
 * any of its keys differs from the learned order; else the count of
 * positions written to flagged, those whose value is not an int in
 * [0, 2^256), which the caller reduces itself. */
Py_ssize_t bpt_read_witness(PyObject *witness, PyObject *keys, const int32_t *slots,
                            const uint64_t *q, uint8_t *out, int32_t *flagged) {
    if (!PyDict_CheckExact(witness) || !PyList_CheckExact(keys) ||
        PyDict_Size(witness) != PyList_GET_SIZE(keys))
        return -1;
    Py_ssize_t pos = 0, i = 0, nflag = 0;
    PyObject *key, *value;
    while (PyDict_Next(witness, &pos, &key, &value)) {
        if (!same_key(key, PyList_GET_ITEM(keys, i)))
            return -1;
        int32_t s = slots[i++];
        if (s < 0)
            continue;
        uint8_t *dst = out + 32 * (size_t)s;
        if (PyLong_Check(value) && as_bytes32(value, dst) == 0)
            reduce(dst, q);
        else
            flagged[nflag++] = s;
    }
    return nflag;
}
