/* annonet_client: C/C++ embedding surface for annonet_serve.
 *
 * The reference's annonet_infer.h:15-17 is explicitly an embedding
 * contract: "this functionality [...] can be included in other
 * applications". In this framework the model executes on the accelerator behind a
 * long-lived annonet_serve process (compiled XLA programs stay warm);
 * the native embedding path for C/C++ applications is this client — a
 * dependency-free HTTP/1.1 client over POSIX sockets that ships pixels
 * to the server's zero-codec raw endpoint and returns the uint16 label
 * map, mirroring the reference's
 *   annonet_infer(net, image, gains, detection_levels) -> result_image
 * call shape (annonet_infer.h:34-42).
 *
 * Every function with an int return gives 0 on success and a negative
 * value on failure; annonet_client_last_error() then holds a
 * human-readable message (including the server's JSON error body on
 * HTTP 4xx/5xx). The handle is NOT thread-safe: create one per thread,
 * or serialize calls (each request opens its own connection, so
 * separate handles never share state).
 *
 * Build:  make -C native libannonet_client.so
 * Demo:   examples/embed_client.cpp
 */
#ifndef ANNONET_CLIENT_H
#define ANNONET_CLIENT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct annonet_client annonet_client;

/* Connect parameters are stored; each request opens a fresh connection
 * (timeout_ms bounds connect + each socket read/write; <= 0 means
 * 120000). Never fails — errors surface on the first request. */
annonet_client* annonet_client_create(const char* host, int port,
                                      int timeout_ms);
void annonet_client_destroy(annonet_client* c);

/* Message for the last failed call on this handle ("" if none). Valid
 * until the next call on the same handle. */
const char* annonet_client_last_error(const annonet_client* c);

/* GET /healthz -> malloc'd JSON string (model path, class palette,
 * downscaling factor, required input dimension, "status"). Returns 0
 * for HTTP 200 AND for 503 — the server serves 503 with the same
 * payload ("status":"stalled") while an in-flight device op exceeds its
 * --device-stall-seconds allowance; read the payload's "status" field.
 * Caller frees with annonet_client_free. */
int annonet_client_healthz(annonet_client* c, char** out_json);

/* POST /infer -> per-pixel class indices at the image's original size.
 *
 * Raw path (zero-codec, preferred for embedding): pass the pixel buffer
 * in `body` (row-major uint8, C channels interleaved) and its shape in
 * raw_h/raw_w/raw_c (c = 1 grayscale or 3 RGB; the server converts to
 * the model's channel layout with the training pipeline's exact math).
 *
 * Encoded path: pass PNG/JPEG bytes and raw_h = raw_w = raw_c = 0.
 *
 * `params` is an optional extra query string, e.g.
 * "gain=1:-0.5&detection=1:2" (the CLI's -g/-d semantics,
 * annonet_infer_main.cpp:36-63), or NULL.
 *
 * On success *out_labels is a malloc'd row-major uint16 array of
 * *out_h x *out_w class indices (native byte order; the wire format is
 * little-endian and is swapped here on big-endian hosts). Caller frees
 * with annonet_client_free. */
int annonet_client_infer(annonet_client* c,
                         const void* body, int64_t body_len,
                         int64_t raw_h, int64_t raw_w, int64_t raw_c,
                         const char* params,
                         uint16_t** out_labels,
                         int64_t* out_h, int64_t* out_w);

void annonet_client_free(void* p);

#ifdef __cplusplus
}
#endif

#endif /* ANNONET_CLIENT_H */
