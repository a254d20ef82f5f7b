// The van (csrc/hetu_ps_van.cpp at the repository root, unchanged) as the
// port builds it, with one repair: its accept loop ends at the first
// accept() that fails, so an accept interrupted by a signal (EINTR: some
// kernels return it after a SIGSTOP and SIGCONT, even with no handler),
// or a queued connection aborted by its client (ECONNABORTED), stops the
// server from accepting for good while its process lives on.  Here a
// failed accept is retried unless the listening socket is gone (EBADF,
// EINVAL: ps_van_stop closed it); an error other than EINTR and
// ECONNABORTED (out of descriptors or memory) waits 10 ms first.
//
// Every system header the van includes comes first, so that the macro
// below renames its one call of accept() and nothing else.
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
#include "../../csrc/hetu_ps_van.cpp"
#undef accept
