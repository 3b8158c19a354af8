/* Minimal C consumer of the rav1e_tpu_torch C API: encodes a synthetic
 * clip and prints one line per packet.  Counterpart of the reference's
 * crav1e usage example; a copy of examples/capi_encode.c that takes the
 * torch device from argv[1] ("cuda", the default, or "cpu").
 *
 * Build (from the repo root):
 *   g++ -O2 rav1e_tpu_torch/capi/capi.cc rav1e_tpu_torch/capi/capi_encode.c \
 *       -Iinclude $(python3-config --includes) \
 *       $(python3-config --ldflags --embed) \
 *       -o build/rav1e_tpu_torch/capi_encode
 * Run with PYTHONPATH=<repo root>: build/rav1e_tpu_torch/capi_encode [cpu]
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "rav1e_tpu.h"

int main(int argc, char **argv) {
  const int W = 96, H = 64, N = 5;
  const char *device = argc > 1 ? argv[1] : "cuda";

  RaConfig *cfg = rav1e_config_default();
  if (!cfg) return 1;
  if (rav1e_config_parse_int(cfg, "width", W)) return 2;
  if (rav1e_config_parse_int(cfg, "height", H)) return 2;
  if (rav1e_config_parse_int(cfg, "speed", 10)) return 2;
  if (rav1e_config_parse_int(cfg, "quantizer", 120)) return 2;
  if (rav1e_config_parse_int(cfg, "low_latency", 1)) return 2;
  if (rav1e_config_parse(cfg, "device", device)) return 2;
  if (rav1e_config_parse(cfg, "no_such_key", "x") == 0) return 3; /* must fail */

  RaContext *ctx = rav1e_context_new(cfg);
  if (!ctx) return 4;
  rav1e_config_unref(cfg);

  uint8_t *y = (uint8_t *)malloc(W * H);
  uint8_t *u = (uint8_t *)malloc(W * H / 4);
  uint8_t *v = (uint8_t *)malloc(W * H / 4);
  int npackets = 0;
  size_t total = 0;

  for (int i = 0; i < N; i++) {
    for (int p = 0; p < W * H; p++) y[p] = (uint8_t)((p + i * 7) & 0xFF);
    memset(u, 100 + i, W * H / 4);
    memset(v, 160 - i, W * H / 4);

    RaFrame *f = rav1e_frame_new(ctx);
    if (!f) return 5;
    if (rav1e_frame_fill_plane(f, 0, y, W * H, W, 1)) return 6;
    if (rav1e_frame_fill_plane(f, 1, u, W * H / 4, W / 2, 1)) return 6;
    if (rav1e_frame_fill_plane(f, 2, v, W * H / 4, W / 2, 1)) return 6;
    if (rav1e_send_frame(ctx, f)) return 7;
    rav1e_frame_unref(f);
  }
  rav1e_send_frame(ctx, NULL); /* flush */

  for (;;) {
    RaPacket *pkt = NULL;
    int st = rav1e_receive_packet(ctx, &pkt);
    if (st == RA_ENCODER_STATUS_LIMIT_REACHED) break;
    if (st == RA_ENCODER_STATUS_NEED_MORE_DATA) continue;
    if (st != RA_ENCODER_STATUS_SUCCESS) return 8;
    printf("packet %d: frame %llu type %d %zu bytes\n", npackets,
           (unsigned long long)pkt->input_frameno, pkt->frame_type, pkt->len);
    total += pkt->len;
    npackets++;
    rav1e_packet_unref(pkt);
  }
  rav1e_context_unref(ctx);

  if (npackets != N || total < 100) return 9;
  printf("OK: %d packets, %zu bytes, %s\n", npackets, total,
         rav1e_version_short());
  free(y); free(u); free(v);
  return 0;
}
