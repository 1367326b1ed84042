/* paddle_tpu native runtime — C API consumed from Python via ctypes.
 *
 * TPU-native re-implementation of the reference's native runtime
 * services (reference: paddle/pserver/ParameterServer2.h blockwise
 * param store + sync barriers + asyncSGD; paddle/optimizer C ABI lib;
 * go/master/service.go task queue with lease timeouts; RecordIO chunks;
 * paddle/memory/detail/buddy_allocator.h).  Transport is framed
 * messages over TCP sockets (reference: paddle/pserver/LightNetwork.h,
 * ProtoServer.h) — gRPC/RDMA replaced by a dependency-free socket
 * protocol; on-TPU collectives live in XLA, this layer serves the
 * DCN/pserver-style path.
 */
#ifndef PADDLE_TPU_RT_H
#define PADDLE_TPU_RT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- parameter server ------------------------------------------------ */
/* sync=1: gradients barrier across num_trainers then one optimizer step
 * (reference: ParameterServer2 addGradient + synchronize barriers);
 * sync=0: apply each gradient immediately (reference: asyncSGD).
 * async_lagged > 0 discards async gradients computed against parameters
 * at least that many versions old (reference: ParameterServer2.h:243
 * lagged-async commit control); 0 = unbounded. */
void *ptrt_pserver_start(int port, int num_trainers, int sync,
                         int async_lagged);
void ptrt_pserver_stop(void *s);
int ptrt_pserver_port(void *s);      /* bound port (0 -> ephemeral) */
int ptrt_pserver_save(void *s, const char *path);  /* checkpoint w/ crc */
int ptrt_pserver_load(void *s, const char *path);
int64_t ptrt_pserver_num_updates(void *s);
int64_t ptrt_pserver_num_lagged(void *s);  /* staleness-discarded count */

/* ---- pserver client -------------------------------------------------- */
void *ptrt_client_connect(const char *host, int port);
void ptrt_client_close(void *c);
/* optimizer config applies per-parameter at init time.
 * kind: 0=sgd 1=momentum 2=adagrad 3=adam */
int ptrt_client_init_param(void *c, const char *name, const float *data,
                           int64_t n, int opt_kind, double lr,
                           double hp1, double hp2, double hp3);
/* blocking: returns after the server applied the (sync: aggregated)
 * update; out receives the fresh parameter (may be NULL).
 * base_version: the parameter version the gradient was computed
 * against (from a prior send_grad/get_param); new_version (may be
 * NULL) receives the server's version.  Returns 4 when the gradient
 * was discarded as stale — out is still the fresh parameter. */
int ptrt_client_send_grad(void *c, const char *name, const float *grad,
                          int64_t n, float *out, int64_t base_version,
                          int64_t *new_version);
int ptrt_client_get_param(void *c, const char *name, float *out,
                          int64_t n, int64_t *version);
/* sparse rows (reference: getParameterSparse / SelectedRows path) */
int ptrt_client_send_sparse_grad(void *c, const char *name,
                                 const int32_t *rows, const float *vals,
                                 int64_t nrows, int64_t width);
int ptrt_client_get_rows(void *c, const char *name, const int32_t *rows,
                         float *out, int64_t nrows, int64_t width);
int ptrt_client_barrier(void *c);     /* pass-start style barrier */

/* ---- master task queue ----------------------------------------------- */
void *ptrt_master_start(int port, int timeout_ms, int failure_max);
void ptrt_master_stop(void *m);
int ptrt_master_port(void *m);
int ptrt_master_snapshot(void *m, const char *path);
int ptrt_master_recover(void *m, const char *path);

void *ptrt_mclient_connect(const char *host, int port);
void ptrt_mclient_close(void *c);
int ptrt_mclient_set_dataset(void *c, const char *const *chunks, int n,
                             int chunks_per_task);
/* returns task id >=0 and fills buf with '\n'-joined chunk names;
 * -1: no task available (all leased, retry later); -2: pass finished
 * (reported once per pass, then the queue recycles for the next pass);
 * -3: transport failure (master unreachable); -4: buf too small for the
 * chunk list (task stays leased; retry with a bigger buffer) */
int64_t ptrt_mclient_get_task(void *c, char *buf, int64_t buflen);
int ptrt_mclient_task_finished(void *c, int64_t task_id);
int ptrt_mclient_task_failed(void *c, int64_t task_id);
/* etcd-style TTL-lease registry (pserver registration/discovery) */
int64_t ptrt_mclient_register(void *c, const char *key, const char *value,
                              int ttl_ms);
int ptrt_mclient_keepalive(void *c, int64_t lease); /* 0 ok, 1 lapsed */
int ptrt_mclient_unregister(void *c, int64_t lease);
int64_t ptrt_mclient_list(void *c, const char *prefix, char *buf,
                          int64_t buflen);

/* ---- recordio --------------------------------------------------------- */
void *ptrt_recordio_writer_open(const char *path);
int ptrt_recordio_write(void *w, const void *data, int64_t n);
int ptrt_recordio_writer_close(void *w);
void *ptrt_recordio_reader_open(const char *path);
/* returns record size (<=buflen) or -1 on EOF, -2 on corruption */
int64_t ptrt_recordio_read(void *r, void *buf, int64_t buflen);
void ptrt_recordio_reader_close(void *r);

/* ---- buddy allocator --------------------------------------------------*/
void *ptrt_buddy_create(int64_t total_bytes, int64_t min_block);
void *ptrt_buddy_alloc(void *a, int64_t n);
void ptrt_buddy_free(void *a, void *p);
int64_t ptrt_buddy_used(void *a);
void ptrt_buddy_destroy(void *a);

#ifdef __cplusplus
}
#endif
#endif /* PADDLE_TPU_RT_H */
