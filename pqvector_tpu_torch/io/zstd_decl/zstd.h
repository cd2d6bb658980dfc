/* The two functions of zstd's public API (zstd.h, stable since v1.0) that
 * native/pqvector_pages.cpp calls. io/native.py builds the library with this
 * directory on the include path, linked against the runtime libzstd.so.1,
 * on hosts that carry zstd's shared library but not its development header.
 */
#ifndef PQVECTOR_ZSTD_DECL_H
#define PQVECTOR_ZSTD_DECL_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif
