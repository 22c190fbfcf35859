/*
 * Stub Shoal runtime (plain-malloc backing) for building the libshoal
 * Green-Marl generated apps without the external Shoal library.
 *
 * The real Shoal (ETH Zurich, USENIX ATC'15) decides per-array NUMA
 * placement (replicate/distribute/partition/hugepage).  This stub keeps
 * the exact generated-code API but backs every array with a single
 * malloc'd buffer — i.e. the "baseline" (no -d/-r/-p) configuration of
 * scripts/run.sh.  CRC reporting uses CRC-16/CCITT-FALSE over the raw
 * array bytes, matching the JAX framework's utils/crc.py so parity
 * harnesses can diff the "CRC shl__<name> 0x...." lines directly.
 */
#ifndef SHL_STUB_H
#define SHL_STUB_H

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <string>
#include <sys/time.h>

/* ------------------------------------------------------------------ */
/* timers                                                              */
/* ------------------------------------------------------------------ */
class Timer {
    double t0;
    static double now() {
        struct timeval tv;
        gettimeofday(&tv, NULL);
        return tv.tv_sec * 1000.0 + tv.tv_usec / 1000.0;
    }
public:
    Timer() : t0(0) {}
    void start() { t0 = now(); }
    double stop() { return now() - t0; }
};

static inline int shl__init(int nthreads, int partitioning) {
    (void)partitioning;
    return nthreads;
}
static inline void shl__start(void) {}
static inline void shl__end(void) {}
static inline void shl__thread_init(void) {}
static inline int shl__get_rep_id(void) { return 0; }

static inline void shl__start_timer(int steps) { (void)steps; }
static inline void shl__step_timer(const char* label) { (void)label; }
static inline void shl__end_timer(const char* label) { (void)label; }

/* COST macro support: generated headers sum per-array estimates */
template <class T>
static inline long shl__estimate_size(long n, const char* name, int ro,
                                      int dyn, int used, int graph,
                                      int indexed) {
    (void)name; (void)ro; (void)dyn; (void)used; (void)graph; (void)indexed;
    return n * (long)sizeof(T);
}
static inline long shl__estimate_working_set_size(int n, ...) {
    va_list ap;
    va_start(ap, n);
    long total = 0;
    for (int i = 0; i < n; i++) total += va_arg(ap, long);
    va_end(ap);
    return total;
}

/* ------------------------------------------------------------------ */
/* CRC-16/CCITT-FALSE (poly 0x1021, init 0xFFFF) over raw bytes        */
/* ------------------------------------------------------------------ */
static inline uint16_t shl__crc16(const void* data, size_t nbytes) {
    static uint16_t table[256];
    static int init = 0;
    if (!init) {
        for (int b = 0; b < 256; b++) {
            uint16_t crc = (uint16_t)(b << 8);
            for (int k = 0; k < 8; k++)
                crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x1021)
                                     : (uint16_t)(crc << 1);
            table[b] = crc;
        }
        init = 1;
    }
    const uint8_t* p = (const uint8_t*)data;
    uint16_t crc = 0xFFFF;
    for (size_t i = 0; i < nbytes; i++)
        crc = (uint16_t)((crc << 8) ^ table[((crc >> 8) ^ p[i]) & 0xFF]);
    return crc;
}

/* ------------------------------------------------------------------ */
/* arrays                                                              */
/* ------------------------------------------------------------------ */
template <class T>
struct arr_thread_ptr {
    T* ptr1;
    T* ptr2;
    T* rep_ptr;
};

template <class T>
class shl_array {
protected:
    size_t n;
    std::string name;
    T* data;
public:
    shl_array(size_t n_, const char* name_) : n(n_), name(name_), data(NULL) {}
    virtual ~shl_array() { free(data); }
    void set_dynamic(bool) {}
    void set_used(bool) {}
    void alloc() {
        if (!data) data = (T*)calloc(n ? n : 1, sizeof(T));
    }
    void copy_from(const T* src) {
        if (src) memcpy(data, src, n * sizeof(T));
    }
    void copy_back(T* dst) {
        if (dst) memcpy(dst, data, n * sizeof(T));
    }
    T* get_array() { return data; }
    size_t size() const { return n; }
    void print_crc() {
        uint16_t crc = shl__crc16(data, n * sizeof(T));
        const char* nm = name.c_str();
        if (strncmp(nm, "shl__", 5) == 0)
            printf("CRC %s 0x%04x\n", nm, crc);
        else
            printf("CRC shl__%s 0x%04x\n", nm, crc);
    }
};

template <class T>
class shl_array_wr_rep : public shl_array<T> {
public:
    shl_array_wr_rep(size_t n_, const char* name_, int (*rep_id)(void))
        : shl_array<T>(n_, name_) { (void)rep_id; }
};

template <class T>
static inline shl_array<T>* shl__malloc_array(size_t n, const char* name,
                                              int ro, int dyn, int used,
                                              int graph, int indexed,
                                              bool do_init) {
    (void)ro; (void)dyn; (void)used; (void)graph; (void)indexed;
    (void)do_init;
    shl_array<T>* a = new shl_array<T>(n, name);
    return a;
}

template <class T>
static inline void shl__wr_rep_ptr_thread_init(shl_array<T>* arr,
                                               arr_thread_ptr<T>* p) {
    /* no write-replication: all three pointers alias the single buffer */
    p->ptr1 = p->ptr2 = p->rep_ptr = arr->get_array();
}

#endif /* SHL_STUB_H */
