/**
 * eventql_tpu C client library — public API.
 *
 * The client-side subset of the reference's C API surface
 * (reference: src/eventql/eventql.h:160-298) over the framed binary
 * protocol (doc/internals/binary_protocol.txt). Implementation is a
 * fresh blocking-socket client written against the wire spec; see
 * evql_client.c.
 */
#ifndef EVQL_CLIENT_H
#define EVQL_CLIENT_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

struct evql_client_s;
typedef struct evql_client_s evql_client_t;

evql_client_t* evql_client_init();

int evql_client_setauth(
    evql_client_t* client,
    const char* key,
    size_t key_len,
    const char* val,
    size_t val_len,
    long flags);

int evql_client_connect(
    evql_client_t* client,
    const char* host,
    unsigned int port,
    const char* database,
    long flags);

int evql_query(
    evql_client_t* client,
    const char* query_string,
    const char* database,
    long flags);

/* -1 error, 0 EOF, 1 row read */
int evql_fetch_row(
    evql_client_t* client,
    const char*** fields,
    size_t** field_lengths);

int evql_column_name(
    evql_client_t* client,
    size_t column_index,
    const char** name,
    size_t* name_len);

int evql_num_columns(evql_client_t* client, size_t* ncols);

int evql_discard_result(evql_client_t* client);

/* -- query flags / options / stats (reference: eventql.h:114-157) ------- */
enum {
  EVQL_QUERY_SWITCHDB = 0x1,
  EVQL_QUERY_MULTISTMT = 0x2,
  EVQL_QUERY_PROGRESS = 0x4,
  EVQL_QUERY_NOSTATS = 0x8
};

enum {
  EVQL_CLIENT_OPT_TIMEOUT = 1L,
  EVQL_CLIENT_OPT_ROWBUFLEN = 2L
};

enum {
  EVQL_STAT_ROWSMODIFIED = 0x1L,
  EVQL_STAT_ROWSSCANNED = 0x2L,
  EVQL_STAT_BYTESSCANNED = 0x3L,
  EVQL_STAT_PROGRESSPERMILL = 0x4L,
  EVQL_STAT_TIMEELAPSED_MS = 0x5L,
  EVQL_STAT_ETA_MS = 0x6L
};

int evql_client_setopt(
    evql_client_t* client,
    int opt,
    const char* val,
    size_t val_len,
    long flags);

/* adopt an already-connected socket and run the HELLO handshake
 * (reference: client.c:1055-1075) */
int evql_client_connectfd(evql_client_t* client, int fd, long flags);

/* called whenever a QUERY_PROGRESS frame arrives while a query runs;
 * read the stats with evql_client_getstat */
void evql_client_setprogresscb(
    evql_client_t* client,
    void (*cb)(evql_client_t* client, void* privdata),
    void* privdata);

uint64_t evql_client_getstat(evql_client_t* client, uint64_t stat);

/* -- layered key=value config (reference: eventql.h:306-345) ------------ */
struct evql_conf_s;
typedef struct evql_conf_s evql_conf_t;

evql_conf_t* evql_conf_init();
void evql_conf_free(evql_conf_t* conf);
int evql_conf_set(evql_conf_t* conf, const char* key, const char* value);
const char* evql_conf_get(evql_conf_t* conf, const char* key);
int evql_conf_load(evql_conf_t* conf, const char* fpath);

/* -1 error, 0 no more results, 1 next result ready */
int evql_next_result(evql_client_t* client);

void evql_client_releasebuffers(evql_client_t* client);

const char* evql_client_geterror(evql_client_t* client);

int evql_client_close(evql_client_t* client);

void evql_client_destroy(evql_client_t* client);

#ifdef __cplusplus
}
#endif

#endif
