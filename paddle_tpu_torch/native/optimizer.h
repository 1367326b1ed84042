// Server-side dense/sparse-row optimizers (internal).
//
// TPU-native equivalent of the reference's C optimizer library that the
// Go pserver executes per gradient (reference: paddle/optimizer/
// sgd_optimizer.cc, adagrad_optimizer.cc, adam_optimizer.cc;
// paddle/parameter/FirstOrderOptimizer.h for the math).
#ifndef PADDLE_TPU_RT_OPTIMIZER_H
#define PADDLE_TPU_RT_OPTIMIZER_H

#include <cmath>
#include <cstdint>
#include <vector>

namespace ptrt {

enum OptKind { kSGD = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3 };

struct Optimizer {
  int kind = kSGD;
  double lr = 0.01;
  double hp1 = 0.0;  // momentum | adagrad eps | adam beta1
  double hp2 = 0.0;  // adam beta2
  double hp3 = 0.0;  // adam eps
  int64_t step = 0;
  std::vector<float> m1, m2;  // state buffers sized on first use

  void ensure(size_t n) {
    if (kind == kMomentum || kind == kAdagrad) {
      if (m1.size() != n) m1.assign(n, 0.f);
    } else if (kind == kAdam) {
      if (m1.size() != n) m1.assign(n, 0.f);
      if (m2.size() != n) m2.assign(n, 0.f);
    }
  }

  // dense update over [begin, end) of the parameter
  void apply(float *param, const float *grad, size_t begin, size_t end) {
    switch (kind) {
      case kSGD:
        for (size_t i = begin; i < end; ++i)
          param[i] -= static_cast<float>(lr) * grad[i - begin];
        break;
      case kMomentum:
        for (size_t i = begin; i < end; ++i) {
          float v = static_cast<float>(hp1) * m1[i] + grad[i - begin];
          m1[i] = v;
          param[i] -= static_cast<float>(lr) * v;
        }
        break;
      case kAdagrad: {
        float eps = hp1 > 0 ? static_cast<float>(hp1) : 1e-6f;
        for (size_t i = begin; i < end; ++i) {
          float g = grad[i - begin];
          m1[i] += g * g;
          param[i] -= static_cast<float>(lr) * g /
                      (std::sqrt(m1[i]) + eps);
        }
        break;
      }
      case kAdam: {
        float b1 = hp1 > 0 ? static_cast<float>(hp1) : 0.9f;
        float b2 = hp2 > 0 ? static_cast<float>(hp2) : 0.999f;
        float eps = hp3 > 0 ? static_cast<float>(hp3) : 1e-8f;
        // step counts whole-parameter updates; callers bump once per
        // apply over the full range (sparse paths pass begin offsets)
        double bc1 = 1.0 - std::pow(b1, static_cast<double>(step));
        double bc2 = 1.0 - std::pow(b2, static_cast<double>(step));
        float alpha = static_cast<float>(
            lr * std::sqrt(bc2 > 0 ? bc2 : 1.0) / (bc1 > 0 ? bc1 : 1.0));
        for (size_t i = begin; i < end; ++i) {
          float g = grad[i - begin];
          m1[i] = b1 * m1[i] + (1.f - b1) * g;
          m2[i] = b2 * m2[i] + (1.f - b2) * g * g;
          param[i] -= alpha * m1[i] / (std::sqrt(m2[i]) + eps);
        }
        break;
      }
    }
  }
};

}  // namespace ptrt

#endif
