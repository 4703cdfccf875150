// Native results aggregator: append one CSV row to a shared results file
// under an exclusive advisory lock.
//
// Equivalent of the reference's host-side join point
// (MCMC/scripts/append_results.py:73-77: fcntl.flock exclusive lock on the
// shared results.csv).  Implemented in C++ so many concurrent sweep
// processes/hosts can fan in without Python-level GIL or partial writes:
// a single O_APPEND write after flock(LOCK_EX) is atomic on POSIX.
//
// Built as a shared library (cc -shared -fPIC) and bound via ctypes
// (flowstate/io/aggregate.py).

#include <cerrno>
#include <cstring>
#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Append `row` (a complete CSV line WITHOUT trailing newline) to `path`.
// If the file is empty/new, `header` is written first.  Returns 0 on
// success, a negative errno on failure.
int append_row_locked(const char* path, const char* header, const char* row) {
    int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (fd < 0) return -errno;

    if (::flock(fd, LOCK_EX) != 0) {
        int e = errno;
        ::close(fd);
        return -e;
    }

    struct stat st;
    if (::fstat(fd, &st) != 0) {
        int e = errno;
        ::flock(fd, LOCK_UN);
        ::close(fd);
        return -e;
    }

    int rc = 0;
    if (st.st_size == 0 && header != nullptr && header[0] != '\0') {
        size_t len = std::strlen(header);
        if (::write(fd, header, len) != (ssize_t)len ||
            ::write(fd, "\n", 1) != 1) {
            rc = -errno;
        }
    }
    if (rc == 0) {
        size_t len = std::strlen(row);
        if (::write(fd, row, len) != (ssize_t)len ||
            ::write(fd, "\n", 1) != 1) {
            rc = -errno;
        }
    }

    ::fsync(fd);
    ::flock(fd, LOCK_UN);
    ::close(fd);
    return rc;
}

}  // extern "C"
