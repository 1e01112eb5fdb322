/* Native host-side helper of baby_plonk_tpu_torch: Keccak-f[1600] for the
 * STROBE-128/merlin Fiat-Shamir transcript (the Keccak half of
 * native/bpt_native.c; the port converts to and from Montgomery form on
 * the device, so the batched host Montgomery multiply has no counterpart).
 *
 * Built as a plain shared library with the system C compiler and bound via
 * ctypes (baby_plonk_tpu_torch/native.py).
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ---- Keccak-f[1600] ----------------------------------------------------- */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

static inline uint64_t rotl(uint64_t v, int n) {
    n &= 63;
    return n ? (v << n) | (v >> (64 - n)) : v;
}

void keccak_f1600(uint8_t *state) {
    uint64_t A[25];
    memcpy(A, state, 200);
    for (int round = 0; round < 24; round++) {
        uint64_t C[5], D[5], B[25];
        for (int x = 0; x < 5; x++)
            C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
        for (int x = 0; x < 5; x++)
            D[x] = C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1);
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                A[x + 5 * y] ^= D[x];
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(A[x + 5 * y], ROT[x + 5 * y]);
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                A[x + 5 * y] =
                    B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y]);
        A[0] ^= RC[round];
    }
    memcpy(state, A, 200);
}
