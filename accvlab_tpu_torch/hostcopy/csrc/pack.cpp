// Parallel scatter-memcpy packer for the hostcopy engine.
//
// TPU-native equivalent of the staging-fill stage of the reference's
// multi_tensor_copier (fill_cpu_staging_buffers, multi_tensor_copier.cpp:647):
// many small host arrays are copied into one contiguous staging buffer by a
// persistent worker pool so a single large host->HBM transfer replaces
// hundreds of small ones. Exposed with C linkage for ctypes.
//
// Concurrency contract: Run() calls are serialized by run_m_ (start_copy
// defaults to a background-thread pool, so two in-flight copies can reach
// accvlab_pack concurrently); workers only touch tasks_ between the
// m_-protected publish in Run() and the m_-protected completion wait, so the
// task vector is never mutated while any thread is inside Drain().
//
// Build: g++ -O3 -march=native -shared -fPIC -o libaccvlab_pack.so pack.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct CopyTask {
    const void* src;
    void* dst;
    size_t size;
};

// Persistent pool: avoids per-call thread spawn cost (the reference keeps a
// global 4-worker CopyThreadPool for the same reason).
class PackPool {
  public:
    explicit PackPool(int num_threads) : stop_(false), active_(0), next_(0), remaining_(0) {
        for (int i = 0; i < num_threads; ++i) {
            workers_.emplace_back([this] { WorkerLoop(); });
        }
    }

    ~PackPool() {
        {
            std::lock_guard<std::mutex> lock(m_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void Run(std::vector<CopyTask>&& tasks) {
        // One batch in flight at a time: a second concurrent Run() must not
        // replace tasks_/next_/remaining_ while workers drain the first.
        std::lock_guard<std::mutex> run_lock(run_m_);
        {
            std::lock_guard<std::mutex> lock(m_);
            tasks_ = std::move(tasks);
            next_.store(0, std::memory_order_relaxed);
            remaining_.store(static_cast<long>(tasks_.size()), std::memory_order_release);
        }
        cv_.notify_all();
        // The calling thread helps drain, then waits until every task is
        // copied AND every worker has left Drain() (a worker that claimed the
        // last index may still be reading tasks_.size()).
        Drain();
        std::unique_lock<std::mutex> lock(m_);
        done_cv_.wait(lock, [this] {
            return remaining_.load(std::memory_order_acquire) == 0 && active_ == 0;
        });
    }

  private:
    void Drain() {
        while (true) {
            size_t i = next_.fetch_add(1, std::memory_order_relaxed);
            if (i >= tasks_.size()) return;
            std::memcpy(tasks_[i].dst, tasks_[i].src, tasks_[i].size);
            remaining_.fetch_sub(1, std::memory_order_release);
        }
    }

    void WorkerLoop() {
        std::unique_lock<std::mutex> lock(m_);
        while (true) {
            cv_.wait(lock, [this] {
                return stop_ || next_.load(std::memory_order_relaxed) < tasks_.size();
            });
            if (stop_) return;
            ++active_;  // under m_: Run()'s completion wait observes us
            lock.unlock();
            Drain();
            lock.lock();
            --active_;
            if (active_ == 0 && remaining_.load(std::memory_order_acquire) == 0) {
                done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::vector<CopyTask> tasks_;
    std::mutex m_;        // guards tasks_ publish, active_, wait predicates
    std::mutex run_m_;    // serializes whole Run() batches
    std::condition_variable cv_;       // work available
    std::condition_variable done_cv_;  // batch complete
    bool stop_;
    int active_;
    std::atomic<size_t> next_;
    std::atomic<long> remaining_;
};

PackPool* g_pool = nullptr;
std::mutex g_pool_mutex;

PackPool* GetPool() {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    if (g_pool == nullptr) g_pool = new PackPool(4);
    return g_pool;
}

}  // namespace

extern "C" {

// Initialize (or resize) the worker pool. Not safe to call concurrently with
// in-flight accvlab_pack calls (the binding layer calls it once at load).
void accvlab_pack_init(int num_threads) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    delete g_pool;
    g_pool = new PackPool(num_threads > 0 ? num_threads : 4);
}

// Copy n arrays (srcs[i], sizes[i] bytes) to dst + offsets[i], in parallel.
// Thread-safe: concurrent calls are serialized inside PackPool::Run.
void accvlab_pack(const void** srcs, const uint64_t* sizes, const uint64_t* offsets,
                  int64_t n, void* dst) {
    PackPool* pool = GetPool();
    std::vector<CopyTask> tasks;
    tasks.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        tasks.push_back(CopyTask{srcs[i], static_cast<char*>(dst) + offsets[i],
                                 static_cast<size_t>(sizes[i])});
    }
    pool->Run(std::move(tasks));
}

}  // extern "C"
