// Embedding annonet-jax inference in a C++ application.
//
// The reference's annonet_infer.h:15-17 invites embedding the inference
// core in other applications; the accelerator equivalent keeps the
// compiled XLA programs warm in an annonet_serve sidecar and embeds this
// thin client (native/annonet_client.h). Start a server first, e.g.
//
//   annonet_serve --model annonet.dnn --quantize int8 --port 8096
//
// then:
//
//   make -C native embed_client
//   ./native/embed_client 127.0.0.1 8096
//
// Sends one synthetic 256x256 RGB image over the zero-codec raw path
// and prints the per-class pixel histogram of the returned label map.

#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "annonet_client.h"

int main(int argc, char** argv) {
    const char* host = argc > 1 ? argv[1] : "127.0.0.1";
    int port = argc > 2 ? atoi(argv[2]) : 8096;

    annonet_client* client = annonet_client_create(host, port, 60000);

    char* health = nullptr;
    if (annonet_client_healthz(client, &health) != 0) {
        fprintf(stderr, "healthz failed: %s\n",
                annonet_client_last_error(client));
        annonet_client_destroy(client);
        return 1;
    }
    printf("server: %s\n", health);
    annonet_client_free(health);

    // A synthetic image; a real application passes its own pixel buffer
    // (row-major uint8, RGB interleaved or single-channel grayscale).
    const int64_t h = 256, w = 256, c = 3;
    std::vector<uint8_t> pixels(h * w * c);
    for (int64_t i = 0; i < h * w * c; ++i) {
        pixels[i] = static_cast<uint8_t>((i * 2654435761u) >> 24);
    }

    uint16_t* labels = nullptr;
    int64_t lh = 0, lw = 0;
    int rc = annonet_client_infer(client, pixels.data(),
                                  static_cast<int64_t>(pixels.size()),
                                  h, w, c, /*params=*/nullptr,
                                  &labels, &lh, &lw);
    if (rc != 0) {
        fprintf(stderr, "infer failed: %s\n",
                annonet_client_last_error(client));
        annonet_client_destroy(client);
        return 1;
    }

    std::vector<int64_t> counts;
    for (int64_t i = 0; i < lh * lw; ++i) {
        if (labels[i] >= counts.size()) counts.resize(labels[i] + 1, 0);
        ++counts[labels[i]];
    }
    printf("label map %" PRId64 "x%" PRId64 ":\n", lh, lw);
    for (size_t k = 0; k < counts.size(); ++k) {
        if (counts[k]) {
            printf("  class %zu: %" PRId64 " px\n", k, counts[k]);
        }
    }

    annonet_client_free(labels);
    annonet_client_destroy(client);
    return 0;
}
