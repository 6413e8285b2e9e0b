// KITTI odometry benchmark evaluator — native C++ implementation.
//
// The port's own copy of native/kitti_devkit.cpp (it computes the same
// files, byte for byte); deepclr_tpu_torch/native builds it at first use.
// The official odometry devkit's evaluation: per-sequence segment errors (lengths
// 100..800 m, one start every 10 frames, normalized by segment length),
// per-sequence error tables and an overall stats file, evaluating all 22
// sequences present in the prediction directory.
//
// Exported C ABI (ctypes):
//   int kitti_eval(const char* gt_dir, const char* pred_dir,
//                  const char* result_dir);
// returns the number of evaluated sequences (<0 on error).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC kitti_devkit.cpp -o libkitti_devkit.so

#include <array>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace {

using Mat4 = std::array<double, 16>;

Mat4 identity() {
  Mat4 m{};
  m[0] = m[5] = m[10] = m[15] = 1.0;
  return m;
}

Mat4 mul(const Mat4 &a, const Mat4 &b) {
  Mat4 c{};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a[i * 4 + k] * b[k * 4 + j];
      c[i * 4 + j] = s;
    }
  return c;
}

Mat4 rigid_inverse(const Mat4 &m) {
  Mat4 r = identity();
  // R^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r[i * 4 + j] = m[j * 4 + i];
  // -R^T t
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += r[i * 4 + j] * m[j * 4 + 3];
    r[i * 4 + 3] = -s;
  }
  return r;
}

bool load_poses(const std::string &file, std::vector<Mat4> &poses) {
  std::ifstream in(file);
  if (!in.good()) return false;
  std::string line;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    Mat4 m = identity();
    for (int i = 0; i < 12; ++i)
      if (!(ss >> m[i])) return false;
    poses.push_back(m);
  }
  return !poses.empty();
}

std::vector<double> trajectory_distances(const std::vector<Mat4> &poses) {
  std::vector<double> dist(poses.size(), 0.0);
  for (size_t i = 1; i < poses.size(); ++i) {
    double dx = poses[i][3] - poses[i - 1][3];
    double dy = poses[i][7] - poses[i - 1][7];
    double dz = poses[i][11] - poses[i - 1][11];
    dist[i] = dist[i - 1] + std::sqrt(dx * dx + dy * dy + dz * dz);
  }
  return dist;
}

int frame_beyond(const std::vector<double> &dist, int first, double len) {
  for (size_t i = first; i < dist.size(); ++i)
    if (dist[i] > dist[first] + len) return static_cast<int>(i);
  return -1;
}

double rotation_error(const Mat4 &d) {
  double tr = d[0] + d[5] + d[10];
  double v = 0.5 * (tr - 1.0);
  if (v > 1.0) v = 1.0;
  if (v < -1.0) v = -1.0;
  return std::acos(v);
}

double translation_error(const Mat4 &d) {
  return std::sqrt(d[3] * d[3] + d[7] * d[7] + d[11] * d[11]);
}

struct SegError {
  int first_frame;
  double r_err;  // rad per meter
  double t_err;  // fraction per meter
  double len;
  double speed;
};

constexpr int kStepSize = 10;
constexpr std::array<double, 8> kLengths = {100, 200, 300, 400,
                                            500, 600, 700, 800};

std::vector<SegError> calc_sequence_errors(const std::vector<Mat4> &gt,
                                           const std::vector<Mat4> &pred) {
  std::vector<SegError> errors;
  auto dist = trajectory_distances(gt);
  size_t n = std::min(gt.size(), pred.size());
  for (size_t first = 0; first < n; first += kStepSize) {
    for (double len : kLengths) {
      int last = frame_beyond(dist, static_cast<int>(first), len);
      if (last < 0 || static_cast<size_t>(last) >= n) continue;
      Mat4 delta_gt = mul(rigid_inverse(gt[first]), gt[last]);
      Mat4 delta_pred = mul(rigid_inverse(pred[first]), pred[last]);
      Mat4 err = mul(rigid_inverse(delta_pred), delta_gt);
      double num_frames = static_cast<double>(last - first + 1);
      errors.push_back({static_cast<int>(first),
                        rotation_error(err) / len,
                        translation_error(err) / len, len,
                        len / (0.1 * num_frames)});
    }
  }
  return errors;
}

bool file_exists(const std::string &f) {
  struct stat st;
  return stat(f.c_str(), &st) == 0;
}

}  // namespace

extern "C" int kitti_eval(const char *gt_dir, const char *pred_dir,
                          const char *result_dir) {
  std::string result(result_dir);
  ::mkdir(result.c_str(), 0755);

  int evaluated = 0;
  double total_t = 0.0, total_r = 0.0;
  size_t total_n = 0;

  std::ofstream stats(result + "/stats.txt");
  if (!stats.good()) return -1;

  for (int seq = 0; seq < 22; ++seq) {
    char name[8];
    std::snprintf(name, sizeof(name), "%02d", seq);
    std::string pred_file = std::string(pred_dir) + "/" + name + ".txt";
    std::string gt_file = std::string(gt_dir) + "/" + name + ".txt";
    if (!file_exists(pred_file) || !file_exists(gt_file)) continue;

    std::vector<Mat4> gt, pred;
    if (!load_poses(gt_file, gt) || !load_poses(pred_file, pred)) continue;

    auto errors = calc_sequence_errors(gt, pred);
    if (errors.empty()) continue;
    ++evaluated;

    // per-sequence raw errors (first_frame r_err t_err len speed)
    std::ofstream seq_out(result + "/errors_" + name + ".txt");
    double t_sum = 0, r_sum = 0;
    for (const auto &e : errors) {
      seq_out << e.first_frame << " " << e.r_err << " " << e.t_err << " "
              << e.len << " " << e.speed << "\n";
      t_sum += e.t_err;
      r_sum += e.r_err;
      total_t += e.t_err;
      total_r += e.r_err;
    }
    total_n += errors.size();

    double n_inv = 1.0 / static_cast<double>(errors.size());
    stats << name << " t_err[%] " << 100.0 * t_sum * n_inv << " r_err[deg/m] "
          << r_sum * n_inv * 180.0 / M_PI << "\n";
  }

  if (total_n > 0) {
    double n_inv = 1.0 / static_cast<double>(total_n);
    stats << "TOTAL t_err[%] " << 100.0 * total_t * n_inv << " r_err[deg/m] "
          << total_r * n_inv * 180.0 / M_PI << "\n";
  }
  return evaluated;
}

int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: kitti_devkit GT_DIR PRED_DIR [RESULT_DIR]\n");
    return 1;
  }
  std::string result =
      argc > 3 ? argv[3] : (std::string(argv[2]) + "/result");
  int n = kitti_eval(argv[1], argv[2], result.c_str());
  if (n < 0) {
    std::fprintf(stderr, "evaluation failed\n");
    return 1;
  }
  std::printf("evaluated %d sequences -> %s\n", n, result.c_str());
  return 0;
}
