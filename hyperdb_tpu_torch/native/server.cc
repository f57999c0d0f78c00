// Native HTTP serving front-end (epoll, keep-alive, request batching).
//
// Role: the serving-plane equivalent of the reference's external native
// dependencies (SURVEY.md §2.3 — the reference ships no server at all; its
// native speed lives in pip C++/Rust libs). Measurement motivated this
// layer: the stdlib ThreadingHTTPServer costs ~1 ms of Python per request
// (HTTP parse + JSON + thread switch), capping serving at ~1.2k q/s while
// the engine sustains 65k q/s batched (benchmarks/bench_serving.py,
// BASELINE.md). Here C++ owns the I/O plane — sockets, HTTP parsing,
// dynamic batching, response formatting — and Python is entered exactly
// once per BATCH through a ctypes worker loop:
//
//     epoll thread (C++)                 worker thread (Python via ctypes)
//     ------------------                 ---------------------------------
//     accept/read/parse  --hot queue-->  hdb_srv_next() == 1
//     (healthz answered inline)            db.query_batch_arrays(...)
//     write responses   <--resp queue--  hdb_srv_batch_complete(ids,scores)
//                        --gen queue-->  hdb_srv_next() == 2 (/stats, JSON)
//                       <--resp queue--  hdb_srv_req_respond(...)
//
// Hot paths: POST /query?top_k=K&metric=M with Content-Type
// application/octet-stream (raw little-endian f32 vector body) or
// text/plain (query text body; the worker embeds the whole batch in one
// encoder pass).
// Requests are grouped by metric; a group flushes when max_batch requests
// are waiting or window_us elapsed since the first arrival (same policy as
// server._DynamicBatcher, moved off the GIL). Connections are fully
// HTTP/1.1-pipelined: up to kMaxInflight requests per connection may be
// in flight at once and responses return in request order (per-connection
// sequence numbers + an out-of-order stash), so a handful of batched
// client connections can keep whole flushes in the air. Responses are JSON
// {"ids":[...],"scores":[...]} or, when the request carried
// Accept: application/octet-stream, a binary body
// [u32 k][k x i64 ids][k x f32 scores].
//
// Single I/O thread by design: requests are ~1.6 KB and responses ~200 B,
// so even 50k q/s is ~100 MB/s of memcpy+parse — far below one core. One
// worker thread by design too: it is the only user of the database and of
// its device, so extra Python workers would only contend the engine lock.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <map>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct HotReq {
  int fd = -1;
  uint64_t gen = 0;
  uint64_t seq = 0;  // per-connection request order (HTTP/1.1 pipelining)
  int top_k = 5;
  bool binary_out = false;
  bool is_text = false;  // text/plain query: `text` set, `vec` empty
  std::vector<float> vec;
  std::string text;
  std::string filters;  // raw JSON filter spec (part of the group key)
  std::string recency;  // recency_bias as its raw decimal string
  std::string tskey;    // timestamp_key
};

struct GenReq {
  int fd = -1;
  uint64_t gen = 0;
  uint64_t seq = 0;
  std::string method, path, ctype, body;
};

struct Response {
  int fd = -1;
  uint64_t gen = 0;
  uint64_t seq = 0;
  std::string data;
};

// Max pipelined (in-flight) requests per connection before the parser
// stops consuming its buffer. One batched client connection can keep a
// whole flush in flight without one-thread-per-request client fleets.
constexpr int kMaxInflight = 256;

struct Conn {
  uint64_t gen = 0;
  std::string in;   // buffered unparsed bytes
  std::string out;  // pending unsent bytes
  bool open = false;
  bool want_close = false;  // close once out drains (after last response)
  bool epollout = false;
  // HTTP/1.1 pipelining: responses must leave in request order even when
  // requests complete out of order (different flushes / metric groups).
  uint64_t seq_parse = 0;  // next sequence number to assign
  uint64_t seq_write = 0;  // next sequence number allowed onto the wire
  std::map<uint64_t, std::string> stash;  // completed out-of-order responses
  int inflight = 0;
};

std::string lower(std::string s) {
  for (char& c : s) c = (char)tolower((unsigned char)c);
  return s;
}

std::string http_response(int status, const char* ctype,
                          const std::string& body, bool keep_alive) {
  const char* reason = status == 200   ? "OK"
                       : status == 400 ? "Bad Request"
                       : status == 404 ? "Not Found"
                       : status == 413 ? "Payload Too Large"
                       : status == 500 ? "Internal Server Error"
                                       : "Error";
  std::string r;
  r.reserve(body.size() + 160);
  char head[256];
  snprintf(head, sizeof(head),
           "HTTP/1.1 %d %s\r\nServer: hyperdb-tpu-torch-native\r\n"
           "Content-Type: %s\r\nContent-Length: %zu\r\n%s\r\n",
           status, reason, ctype, body.size(),
           keep_alive ? "" : "Connection: close\r\n");
  r.append(head);
  r.append(body);
  return r;
}

std::string json_error(int status, const std::string& msg, bool keep_alive) {
  std::string body = "{\"error\": \"";
  for (char c : msg) {  // minimal JSON string escape
    if (c == '"' || c == '\\') body.push_back('\\');
    if ((unsigned char)c >= 0x20) body.push_back(c);
  }
  body += "\"}";
  return http_response(status, "application/json", body, keep_alive);
}

struct Server {
  int listen_fd = -1, epoll_fd = -1, event_fd = -1;
  int port = 0;
  int dim = 0;
  int max_batch = 256;
  int64_t window_us = 2000;
  size_t max_body = 8u << 20;
  std::atomic<bool> stopping{false};
  std::thread io_thread;

  std::vector<Conn> conns;  // indexed by fd
  uint64_t gen_counter = 1;

  // worker-facing queues
  struct Group {
    std::vector<HotReq> reqs;
    Clock::time_point first;  // oldest waiting request's arrival
  };
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<std::string, Group> hot;  // group key -> pending
  std::deque<GenReq> gen_q;

  // the single in-flight item handed to the worker
  std::vector<HotReq> cur_batch;
  std::string cur_metric;
  std::string cur_filters;
  std::string cur_recency;
  std::string cur_tskey;
  std::vector<float> cur_vecs;
  std::vector<int32_t> cur_topks;
  GenReq cur_req;

  // completed responses, drained by the epoll thread
  std::mutex resp_mu;
  std::deque<Response> resp_q;

  Conn& conn(int fd) {
    if ((size_t)fd >= conns.size()) conns.resize(fd + 1);
    return conns[fd];
  }

  void wake_io() {
    uint64_t one = 1;
    ssize_t r = write(event_fd, &one, sizeof(one));
    (void)r;
  }

  void push_response(int fd, uint64_t gen, uint64_t seq, std::string data) {
    {
      std::lock_guard<std::mutex> lk(resp_mu);
      resp_q.push_back(Response{fd, gen, seq, std::move(data)});
    }
    wake_io();
  }
};

void epoll_mod(Server* s, int fd, bool want_out) {
  Conn& c = s->conn(fd);
  if (c.epollout == want_out) return;
  c.epollout = want_out;
  epoll_event ev{};
  ev.events = EPOLLIN | (want_out ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
}

void close_conn(Server* s, int fd) {
  Conn& c = s->conn(fd);
  if (!c.open) return;
  c.open = false;
  c.in.clear();
  c.out.clear();
  c.stash.clear();
  c.inflight = 0;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
}

// flush c.out; returns false if the connection died
bool flush_out(Server* s, int fd) {
  Conn& c = s->conn(fd);
  while (!c.out.empty()) {
    ssize_t n = send(fd, c.out.data(), c.out.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c.out.erase(0, (size_t)n);
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      epoll_mod(s, fd, true);
      return true;
    }
    close_conn(s, fd);
    return false;
  }
  epoll_mod(s, fd, false);
  // close only after the LAST pipelined response left (responses for
  // later sequence numbers may still be in flight with the worker)
  if (c.want_close && c.seq_write == c.seq_parse) {
    close_conn(s, fd);
    return false;
  }
  return true;
}

// Hand a completed response (worker or inline) to its connection in
// REQUEST order: HTTP/1.1 pipelining requires in-order responses, but
// requests from one connection can complete out of order when they land
// in different flushes. Out-of-order completions wait in c.stash.
// Returns false if the connection died.
bool deliver(Server* s, int fd, uint64_t seq, std::string data) {
  Conn& c = s->conn(fd);
  if (!c.open) return false;
  if (c.inflight > 0) c.inflight--;
  if (seq != c.seq_write) {
    c.stash.emplace(seq, std::move(data));
    return true;
  }
  c.out += data;
  c.seq_write++;
  auto it = c.stash.begin();
  while (it != c.stash.end() && it->first == c.seq_write) {
    c.out += it->second;
    c.seq_write++;
    it = c.stash.erase(it);
  }
  return flush_out(s, fd);
}

// decode %xx in query-string values (metric names are plain, but be correct)
std::string url_decode(const std::string& v) {
  std::string out;
  out.reserve(v.size());
  for (size_t i = 0; i < v.size(); ++i) {
    if (v[i] == '%' && i + 2 < v.size()) {
      char hex[3] = {v[i + 1], v[i + 2], 0};
      out.push_back((char)strtol(hex, nullptr, 16));
      i += 2;
    } else if (v[i] == '+') {
      out.push_back(' ');
    } else {
      out.push_back(v[i]);
    }
  }
  return out;
}

// Group keys are metric strings with a "\x01t" suffix marking text
// batches; a %01-encoded byte in the metric parameter could forge that
// marker (vector requests flushed as a bogus text batch), so metrics with
// control bytes are rejected outright.
// metric [+ "\x01t" text marker] [+ "\x02" filters JSON] [+ "\x03"
// recency_bias] [+ "\x04" timestamp_key]: requests coalesce only when
// EVERY batching-relevant parameter matches.
std::string group_key(const std::string& metric, const HotReq& req) {
  std::string k = metric;
  if (req.is_text) k += "\x01t";
  if (!req.filters.empty()) {
    k += '\x02';
    k += req.filters;
  }
  if (!req.recency.empty()) {
    k += '\x03';
    k += req.recency;
  }
  if (!req.tskey.empty()) {
    k += '\x04';
    k += req.tskey;
  }
  return k;
}

bool metric_is_clean(const std::string& m) {
  for (unsigned char ch : m)
    if (ch < 0x20) return false;
  return true;
}

void parse_query_string(const std::string& qs, HotReq* req,
                        std::string* metric) {
  size_t pos = 0;
  while (pos < qs.size()) {
    size_t amp = qs.find('&', pos);
    if (amp == std::string::npos) amp = qs.size();
    std::string kv = qs.substr(pos, amp - pos);
    size_t eq = kv.find('=');
    if (eq != std::string::npos) {
      std::string k = kv.substr(0, eq), v = url_decode(kv.substr(eq + 1));
      if (k == "top_k") req->top_k = atoi(v.c_str());
      if (k == "metric") *metric = v;
      if (k == "filters") req->filters = v;
      if (k == "recency_bias") req->recency = v;
      if (k == "timestamp_key") req->tskey = v;
    }
    pos = amp + 1;
  }
}

// Parse one complete HTTP request out of c.in. Returns:
//   0 = need more bytes, 1 = consumed (handled), -1 = fatal (conn closed)
int try_parse_request(Server* s, int fd) {
  Conn& c = s->conn(fd);
  size_t hdr_end = c.in.find("\r\n\r\n");
  if (hdr_end == std::string::npos) {
    if (c.in.size() > 16384) {
      // fatal framing error: the byte stream is unrecoverable, but the
      // error response still takes a sequence slot so it cannot overtake
      // responses of earlier pipelined requests still with the worker
      c.want_close = true;
      uint64_t eseq = c.seq_parse++;
      c.inflight++;
      deliver(s, fd, eseq, json_error(400, "headers too large", false));
      return -1;
    }
    return 0;
  }
  // request line
  size_t line_end = c.in.find("\r\n");
  std::string line = c.in.substr(0, line_end);
  size_t sp1 = line.find(' ');
  size_t sp2 = line.rfind(' ');
  if (sp1 == std::string::npos || sp2 == sp1) {
    c.want_close = true;
    uint64_t eseq = c.seq_parse++;
    c.inflight++;
    deliver(s, fd, eseq, json_error(400, "malformed request line", false));
    return -1;
  }
  std::string method = line.substr(0, sp1);
  std::string target = line.substr(sp1 + 1, sp2 - sp1 - 1);
  std::string version = line.substr(sp2 + 1);
  bool keep_alive = version != "HTTP/1.0";

  // headers
  size_t content_length = 0;
  std::string ctype, accept;
  size_t pos = line_end + 2;
  while (pos < hdr_end) {
    size_t eol = c.in.find("\r\n", pos);
    std::string h = c.in.substr(pos, eol - pos);
    pos = eol + 2;
    size_t colon = h.find(':');
    if (colon == std::string::npos) continue;
    std::string name = lower(h.substr(0, colon));
    size_t vstart = h.find_first_not_of(" \t", colon + 1);
    std::string value = vstart == std::string::npos ? "" : h.substr(vstart);
    if (name == "content-length") content_length = (size_t)atoll(value.c_str());
    else if (name == "content-type") ctype = lower(value);
    else if (name == "accept") accept = lower(value);
    else if (name == "connection" && lower(value) == "close") keep_alive = false;
  }
  if (content_length > s->max_body) {
    c.want_close = true;
    uint64_t eseq = c.seq_parse++;
    c.inflight++;
    deliver(s, fd, eseq, json_error(413, "body too large", false));
    return -1;
  }
  size_t total = hdr_end + 4 + content_length;
  if (c.in.size() < total) return 0;

  std::string body = c.in.substr(hdr_end + 4, content_length);
  c.in.erase(0, total);
  if (!keep_alive) c.want_close = true;
  uint64_t seq = c.seq_parse++;
  c.inflight++;

  std::string path = target, qs;
  size_t qmark = target.find('?');
  if (qmark != std::string::npos) {
    path = target.substr(0, qmark);
    qs = target.substr(qmark + 1);
  }

  // answered inline, no Python (still sequenced: an inline answer must
  // not overtake earlier pipelined responses still with the worker)
  if (method == "GET" && path == "/healthz") {
    return deliver(s, fd, seq,
                   http_response(200, "application/json", "{\"ok\": true}",
                                 keep_alive))
               ? 1
               : -1;
  }

  // hot path: raw f32 vector query
  if (method == "POST" && path == "/query" &&
      ctype == "application/octet-stream") {
    if (body.size() != (size_t)s->dim * 4) {
      char msg[128];
      snprintf(msg, sizeof(msg),
               "query vector has %zu bytes, corpus dimension %d needs %d",
               body.size(), s->dim, s->dim * 4);
      return deliver(s, fd, seq, json_error(400, msg, keep_alive)) ? 1 : -1;
    }
    HotReq req;
    req.fd = fd;
    req.gen = c.gen;
    req.seq = seq;
    req.binary_out = accept.find("application/octet-stream") !=
                     std::string::npos;
    std::string metric = "cosine_similarity";
    parse_query_string(qs, &req, &metric);
    if (req.top_k <= 0) {
      return deliver(s, fd, seq,
                     json_error(400, "top_k must be positive", keep_alive))
                 ? 1
                 : -1;
    }
    if (!metric_is_clean(metric) || !metric_is_clean(req.filters) ||
        !metric_is_clean(req.recency) || !metric_is_clean(req.tskey)) {
      return deliver(s, fd, seq,
                     json_error(400, "invalid query parameters", keep_alive))
                 ? 1
                 : -1;
    }
    req.vec.resize(s->dim);
    memcpy(req.vec.data(), body.data(), body.size());
    {
      std::lock_guard<std::mutex> lk(s->mu);
      auto& group = s->hot[group_key(metric, req)];
      if (group.reqs.empty()) group.first = Clock::now();
      group.reqs.push_back(std::move(req));
    }
    s->cv.notify_one();
    return 1;
  }

  // hot path: text query (embedded + scored batched by the worker).
  // Group key gets a "\x01t" suffix so text and vector batches with the
  // same metric never mix in one flush.
  if (method == "POST" && path == "/query" &&
      ctype.rfind("text/plain", 0) == 0) {
    if (body.empty()) {
      return deliver(s, fd, seq,
                     json_error(400, "empty query text", keep_alive))
                 ? 1
                 : -1;
    }
    HotReq req;
    req.fd = fd;
    req.gen = c.gen;
    req.seq = seq;
    req.is_text = true;
    req.binary_out = accept.find("application/octet-stream") !=
                     std::string::npos;
    std::string metric = "cosine_similarity";
    parse_query_string(qs, &req, &metric);
    if (req.top_k <= 0) {
      return deliver(s, fd, seq,
                     json_error(400, "top_k must be positive", keep_alive))
                 ? 1
                 : -1;
    }
    if (!metric_is_clean(metric) || !metric_is_clean(req.filters) ||
        !metric_is_clean(req.recency) || !metric_is_clean(req.tskey)) {
      return deliver(s, fd, seq,
                     json_error(400, "invalid query parameters", keep_alive))
                 ? 1
                 : -1;
    }
    req.text = std::move(body);
    {
      std::lock_guard<std::mutex> lk(s->mu);
      auto& group = s->hot[group_key(metric, req)];
      if (group.reqs.empty()) group.first = Clock::now();
      group.reqs.push_back(std::move(req));
    }
    s->cv.notify_one();
    return 1;
  }

  // everything else goes to the Python dispatcher
  GenReq req;
  req.fd = fd;
  req.gen = c.gen;
  req.seq = seq;
  req.method = std::move(method);
  req.path = std::move(target);  // keep the query string for Python
  req.ctype = std::move(ctype);
  req.body = std::move(body);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->gen_q.push_back(std::move(req));
  }
  s->cv.notify_one();
  return 1;
}

void parse_buffered(Server* s, int fd) {
  Conn& c = s->conn(fd);
  while (c.open && !c.want_close && c.inflight < kMaxInflight) {
    int r = try_parse_request(s, fd);
    if (r <= 0) break;
  }
}

void handle_readable(Server* s, int fd) {
  Conn& c = s->conn(fd);
  char buf[65536];
  for (;;) {
    ssize_t n = recv(fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c.in.append(buf, (size_t)n);
      if (c.in.size() > (8u << 20) + s->max_body) {
        close_conn(s, fd);  // runaway buffer beyond any legal pipeline
        return;
      }
      if ((size_t)n < sizeof(buf)) break;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    close_conn(s, fd);
    return;
  }
  parse_buffered(s, fd);
}

void drain_responses(Server* s) {
  std::deque<Response> batch;
  {
    std::lock_guard<std::mutex> lk(s->resp_mu);
    batch.swap(s->resp_q);
  }
  for (Response& r : batch) {
    if ((size_t)r.fd >= s->conns.size()) continue;
    Conn& c = s->conns[r.fd];
    if (!c.open || c.gen != r.gen) continue;  // conn died / fd reused
    if (!deliver(s, r.fd, r.seq, std::move(r.data))) continue;
    // parse any pipelined requests buffered while at the inflight cap
    parse_buffered(s, r.fd);
  }
}

void io_loop(Server* s) {
  epoll_event events[256];
  while (!s->stopping.load(std::memory_order_relaxed)) {
    int n = epoll_wait(s->epoll_fd, events, 256, 100);
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn& c = s->conn(cfd);
          c = Conn{};
          c.open = true;
          c.gen = s->gen_counter++;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (fd == s->event_fd) {
        uint64_t junk;
        ssize_t r = read(s->event_fd, &junk, sizeof(junk));
        (void)r;
        drain_responses(s);
        continue;
      }
      if (events[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, fd);
        continue;
      }
      if (events[i].events & EPOLLOUT) {
        if (!flush_out(s, fd)) continue;
      }
      if (events[i].events & EPOLLIN) handle_readable(s, fd);
    }
    drain_responses(s);  // eventfd races are harmless; drain every tick
  }
  // shutdown: close everything
  for (size_t fd = 0; fd < s->conns.size(); ++fd) {
    if (s->conns[fd].open) close_conn(s, (int)fd);
  }
}

void append_json_row(std::string* body, const int64_t* ids,
                     const float* scores, int k) {
  *body += "{\"ids\": [";
  char num[64];
  for (int j = 0; j < k; ++j) {
    snprintf(num, sizeof(num), j ? ", %lld" : "%lld", (long long)ids[j]);
    *body += num;
  }
  *body += "], \"scores\": [";
  for (int j = 0; j < k; ++j) {
    snprintf(num, sizeof(num), j ? ", %.7g" : "%.7g", (double)scores[j]);
    *body += num;
  }
  *body += "]}";
}

}  // namespace

extern "C" {

void* hdb_srv_create(const char* host, int port, int dim, int max_batch,
                     int window_us, long long max_body) {
  Server* s = new Server();
  s->dim = dim;
  s->max_batch = max_batch > 0 ? max_batch : 256;
  s->window_us = window_us > 0 ? window_us : 2000;
  if (max_body > 0) s->max_body = (size_t)max_body;

  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host && *host ? host : "127.0.0.1",
                &addr.sin_addr) != 1) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
      listen(s->listen_fd, 1024) < 0) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);

  s->epoll_fd = epoll_create1(0);
  s->event_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->event_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->event_fd, &ev);

  s->io_thread = std::thread(io_loop, s);
  return s;
}

int hdb_srv_port(void* sp) { return ((Server*)sp)->port; }

// Blocks until work is available. 1 = hot vector batch, 2 = generic
// request, 3 = hot text batch, 0 = shutdown.
int hdb_srv_next(void* sp) {
  Server* s = (Server*)sp;
  std::unique_lock<std::mutex> lk(s->mu);
  for (;;) {
    if (!s->gen_q.empty()) {
      s->cur_req = std::move(s->gen_q.front());
      s->gen_q.pop_front();
      return 2;
    }
    if (!s->hot.empty()) {
      auto now = Clock::now();
      // Flush policy: a FULL group flushes immediately (biggest first);
      // otherwise the OLDEST group whose own window expired. Per-group
      // arrival times make this starvation-free — a minority metric's
      // window cannot be reset by the majority's flushes.
      const std::string* key = nullptr;
      size_t biggest = 0;
      for (auto& kv : s->hot) {
        if (kv.second.reqs.size() >= (size_t)s->max_batch &&
            kv.second.reqs.size() > biggest) {
          biggest = kv.second.reqs.size();
          key = &kv.first;
        }
      }
      Clock::time_point oldest = now;
      if (!key) {
        for (auto& kv : s->hot) {
          if (kv.second.first <= oldest) {
            oldest = kv.second.first;
            key = &kv.first;
          }
        }
        bool expired =
            now - oldest >= std::chrono::microseconds(s->window_us);
        if (!expired && !s->stopping.load()) {
          s->cv.wait_until(
              lk, oldest + std::chrono::microseconds(s->window_us));
          continue;
        }
      }
      {
        auto it = s->hot.find(*key);
        auto& group = it->second.reqs;
        size_t take = group.size() < (size_t)s->max_batch
                          ? group.size()
                          : (size_t)s->max_batch;
        s->cur_batch.assign(std::make_move_iterator(group.begin()),
                            std::make_move_iterator(group.begin() + take));
        group.erase(group.begin(), group.begin() + take);
        s->cur_metric = *key;
        // strip group-key decorations innermost-first; per-field values
        // come from the batch head (all members share the group)
        for (char marker : {'\x04', '\x03', '\x02'}) {
          size_t p = s->cur_metric.find(marker);
          if (p != std::string::npos) s->cur_metric.resize(p);
        }
        size_t sep = s->cur_metric.find('\x01');
        bool is_text = sep != std::string::npos;
        if (is_text) s->cur_metric.resize(sep);
        if (!s->cur_batch.empty()) {
          s->cur_filters = s->cur_batch[0].filters;
          s->cur_recency = s->cur_batch[0].recency;
          s->cur_tskey = s->cur_batch[0].tskey;
        } else {
          s->cur_filters.clear();
          s->cur_recency.clear();
          s->cur_tskey.clear();
        }
        if (group.empty()) s->hot.erase(it);
        else it->second.first = now;  // leftovers start a fresh window
        s->cur_topks.resize(s->cur_batch.size());
        for (size_t i = 0; i < s->cur_batch.size(); ++i)
          s->cur_topks[i] = s->cur_batch[i].top_k;
        if (is_text) return 3;
        s->cur_vecs.resize(s->cur_batch.size() * (size_t)s->dim);
        for (size_t i = 0; i < s->cur_batch.size(); ++i) {
          memcpy(s->cur_vecs.data() + i * (size_t)s->dim,
                 s->cur_batch[i].vec.data(), (size_t)s->dim * 4);
        }
        return 1;
      }
    }
    if (s->stopping.load()) return 0;
    s->cv.wait(lk);
  }
}

int hdb_srv_batch_size(void* sp) {
  return (int)((Server*)sp)->cur_batch.size();
}
const float* hdb_srv_batch_vecs(void* sp) {
  return ((Server*)sp)->cur_vecs.data();
}
const int32_t* hdb_srv_batch_topks(void* sp) {
  return ((Server*)sp)->cur_topks.data();
}
const char* hdb_srv_batch_metric(void* sp) {
  return ((Server*)sp)->cur_metric.c_str();
}
const char* hdb_srv_batch_filters(void* sp) {
  return ((Server*)sp)->cur_filters.c_str();
}
const char* hdb_srv_batch_recency(void* sp) {
  return ((Server*)sp)->cur_recency.c_str();
}
const char* hdb_srv_batch_tskey(void* sp) {
  return ((Server*)sp)->cur_tskey.c_str();
}
const char* hdb_srv_batch_text(void* sp, int i, long long* len) {
  Server* s = (Server*)sp;
  if (i < 0 || (size_t)i >= s->cur_batch.size()) {
    if (len) *len = 0;
    return "";
  }
  const std::string& t = s->cur_batch[(size_t)i].text;
  if (len) *len = (long long)t.size();  // NUL bytes in the body survive
  return t.data();
}

// ids/scores are (B, k) row-major; each request gets its own top_k prefix.
void hdb_srv_batch_complete(void* sp, const long long* ids,
                            const float* scores, int k) {
  Server* s = (Server*)sp;
  for (size_t i = 0; i < s->cur_batch.size(); ++i) {
    HotReq& req = s->cur_batch[i];
    int ki = req.top_k < k ? req.top_k : k;
    const int64_t* row_ids = (const int64_t*)ids + (size_t)i * k;
    const float* row_scores = scores + (size_t)i * k;
    std::string resp;
    if (req.binary_out) {
      std::string body;
      body.resize(4 + (size_t)ki * 12);
      uint32_t kn = (uint32_t)ki;
      memcpy(&body[0], &kn, 4);
      memcpy(&body[4], row_ids, (size_t)ki * 8);
      memcpy(&body[4 + (size_t)ki * 8], row_scores, (size_t)ki * 4);
      resp = http_response(200, "application/octet-stream", body, true);
    } else {
      std::string body;
      body.reserve(32 * (size_t)ki + 32);
      append_json_row(&body, row_ids, row_scores, ki);
      resp = http_response(200, "application/json", body, true);
    }
    s->push_response(req.fd, req.gen, req.seq, std::move(resp));
  }
  s->cur_batch.clear();
}

void hdb_srv_batch_fail(void* sp, int status, const char* msg) {
  Server* s = (Server*)sp;
  std::string resp = json_error(status, msg ? msg : "engine error", true);
  for (HotReq& req : s->cur_batch)
    s->push_response(req.fd, req.gen, req.seq, resp);
  s->cur_batch.clear();
}

const char* hdb_srv_req_method(void* sp) {
  return ((Server*)sp)->cur_req.method.c_str();
}
const char* hdb_srv_req_path(void* sp) {
  return ((Server*)sp)->cur_req.path.c_str();
}
const char* hdb_srv_req_ctype(void* sp) {
  return ((Server*)sp)->cur_req.ctype.c_str();
}
const char* hdb_srv_req_body(void* sp, long long* len) {
  Server* s = (Server*)sp;
  *len = (long long)s->cur_req.body.size();
  return s->cur_req.body.data();
}

void hdb_srv_req_respond(void* sp, int status, const char* ctype,
                         const char* body, long long len) {
  Server* s = (Server*)sp;
  std::string b(body ? body : "", body ? (size_t)len : 0);
  s->push_response(s->cur_req.fd, s->cur_req.gen, s->cur_req.seq,
                   http_response(status, ctype ? ctype : "application/json",
                                 b, true));
}

void hdb_srv_stop(void* sp) {
  Server* s = (Server*)sp;
  s->stopping.store(true);
  s->cv.notify_all();
  s->wake_io();
}

void hdb_srv_destroy(void* sp) {
  Server* s = (Server*)sp;
  s->stopping.store(true);
  s->cv.notify_all();
  s->wake_io();
  if (s->io_thread.joinable()) s->io_thread.join();
  if (s->listen_fd >= 0) close(s->listen_fd);
  if (s->epoll_fd >= 0) close(s->epoll_fd);
  if (s->event_fd >= 0) close(s->event_fd);
  delete s;
}

}  // extern "C"
