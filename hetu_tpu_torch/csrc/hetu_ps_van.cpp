// The van (csrc/hetu_ps_van.cpp at the repository root, unchanged) as the
// port builds it, with two repairs.
//
// The accept loop: the van's ends at the first accept() that fails, so
// an accept interrupted by a signal (EINTR: some kernels return it after
// a SIGSTOP and SIGCONT, even with no handler), or a queued connection
// aborted by its client (ECONNABORTED), stops the server from accepting
// for good while its process lives on.  Here a failed accept is retried
// unless the listening socket is gone (EBADF, EINVAL: ps_van_stop closed
// it); an error other than EINTR and ECONNABORTED (out of descriptors or
// memory) waits 10 ms first.
//
// The client's close: a request holds its connection's mutex (one
// request in flight a connection), looked up by the fd's number.  The
// van's ps_van_close takes that mutex out of the table, drains it,
// closes the fd and frees it.  A thread that looked the mutex up just
// before then locks freed memory (and may wait on it for good), and a
// thread that looks it up just after gets a fresh mutex while a request
// still holds the old one: two requests interleave their frames on one
// socket and the stream desyncs.  Both happen in one process whenever
// one thread closes a connection whose transport failed while another
// sends on it (a replicated table's beat and control reads when the
// primary van dies).  Here each fd number keeps its mutex for the life
// of the process, and the close runs under it: a request in flight
// finishes first, and a later one on the same number is serialised with
// whatever connection holds the number next.
//
// Every system header the van includes comes first, so that the macros
// below rename its one call of accept() and its ps_van_close.
#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <utility>
#include <vector>

static int hetu_van_accept(int fd, sockaddr* addr, socklen_t* len) {
  for (;;) {
    int c = ::accept(fd, addr, len);
    if (c >= 0 || errno == EBADF || errno == EINVAL || errno == ENOTSOCK)
      return c;
    if (errno != EINTR && errno != ECONNABORTED)  // out of descriptors or
      // memory, or anything else: do not spin
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
}

#define accept hetu_van_accept
#define ps_van_close hetu_van_close_freeing_mutex
#include "../../csrc/hetu_ps_van.cpp"
#undef ps_van_close
#undef accept

extern "C" void ps_van_close(int fd) {
  if (fd < 0) return;
  std::lock_guard<std::mutex> lk(handle_mutex(fd));
  ::close(fd);
}
