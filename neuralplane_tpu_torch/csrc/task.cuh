// Task layer of the three control tasks as a device function: twin of
// neuralplane_tpu_torch/ops/task.py:task_rows (and of the TPU's
// neuralplane_tpu/ops/task_pallas.py:task_rows), for one aircraft.
#pragma once

namespace np_task {

constexpr double PI_D = 3.141592653589793;
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI_F = (float)(2.0 * PI_D);
constexpr float FT = 0.3048f;
constexpr float THRUST_NORM = (float)(0.3048 / (0.225 * 76300.0));
constexpr float R2D = (float)(180.0 / PI_D);
constexpr float DEG5 = (float)(PI_D / 36.0);  // 5 degrees in rad

enum Variant { HEADING = 0, CONTROL = 1, TRACKING = 2 };

struct TaskConsts {
  float airspeed, acc_limit, alt_limit, max_mach, min_mach;
  float min_alpha, max_alpha, min_beta, max_beta;
  int max_check, min_check;
};

// wrap into (-pi, pi] with a floored modulo, as jnp.mod / torch.remainder:
// fmodf truncates, so a negative remainder takes one period.
__device__ __forceinline__ float wrap_pi(float a) {
  float r = fmodf(a, TWO_PI_F);
  if (r != 0.0f && r < 0.0f) r = r + TWO_PI_F;
  if (r < 0.0f) r = r + TWO_PI_F;
  if (r > PI_F) r = r - TWO_PI_F;
  return r;
}

// s[12], u[5] post-step state and control; xd[12] step-start derivative;
// tr[3] targets; sc post-reset step count. Writes obs[22], the six
// conditions (COND_NAMES order) and returns through done/bad/reward.
__device__ __forceinline__ void task_rows(int variant, const TaskConsts& c,
                                          const float s[12], const float u[5],
                                          const float xd[12], const float tr[3],
                                          int sc, float obs[22], bool conds[6],
                                          bool& done, bool& bad, float& reward) {
  const float npos = s[0], epos = s[1], alt = s[2];
  const float roll = s[3], pitch = s[4], hdg = s[5];
  const float vt = s[6], alpha = s[7], beta = s[8];
  const float P = s[9], Q = s[10], R = s[11];
  const float t0 = tr[0], t1 = tr[1], t2 = tr[2];

  if (variant == HEADING) {
    obs[0] = (alt - t0) * FT / 1000.0f;
    obs[1] = wrap_pi(hdg - t1);
    obs[2] = (vt - t2) * FT / 340.0f;
  } else if (variant == CONTROL) {
    obs[0] = wrap_pi(pitch - t0);
    obs[1] = wrap_pi(hdg - t1);
    obs[2] = (vt - t2) * FT / 340.0f;
  } else {
    obs[0] = (npos - t0) * FT / 1000.0f;
    obs[1] = (epos - t1) * FT / 1000.0f;
    obs[2] = (alt - t2) * FT / 1000.0f;
  }

  const float tfac = 1.0f - 0.703e-5f * alt;
  const float eas2tas = sqrtf(1.0f / powf(tfac, 4.14f));
  const float TAS = vt + c.airspeed;
  const float EAS = TAS / eas2tas;
  const float sin_a = sinf(alpha), cos_a = cosf(alpha);
  const float sin_b = sinf(beta), cos_b = cosf(beta);
  obs[3] = alt * FT / 5000.0f;
  obs[4] = sinf(roll);
  obs[5] = cosf(roll);
  obs[6] = sinf(pitch);
  obs[7] = cosf(pitch);
  obs[8] = EAS * FT / 340.0f;
  obs[9] = sin_a;
  obs[10] = cos_a;
  obs[11] = sin_b;
  obs[12] = cos_b;
  obs[13] = P;
  obs[14] = Q;
  obs[15] = R;
  obs[16] = u[0] * THRUST_NORM;
  obs[17] = u[1] / 45.0f;
  obs[18] = u[2] / 45.0f;
  obs[19] = u[3] / 45.0f;
  obs[20] = u[4] / 45.0f;
  obs[21] = eas2tas;

  // overload: body acceleration from the step-start xdot
  const float vel_u = vt * cos_b * cos_a;
  const float vel_v = vt * sin_b;
  const float vel_w = vt * cos_b * sin_a;
  const float vt_d = xd[6], al_d = xd[7], be_d = xd[8];
  const float u_dot = cos_b * cos_a * vt_d - vt * sin_b * cos_a * be_d
                      - vt * cos_b * sin_a * al_d;
  const float v_dot = sin_b * vt_d + vt * cos_b * be_d;
  const float w_dot = cos_b * sin_a * vt_d - vt * sin_b * sin_a * be_d
                      + vt * cos_b * cos_a * al_d;
  const float ax = u_dot + Q * vel_w - R * vel_v;
  const float ay = v_dot + R * vel_u - P * vel_w;
  const float az = w_dot + P * vel_v - Q * vel_u;
  const float acc = sqrtf(ax * ax + ay * ay + az * az);
  const bool c_overload = acc > c.acc_limit;
  const bool c_low_alt = alt < c.alt_limit;
  const float mach = TAS * FT / 340.0f;
  const bool c_high_spd = mach >= c.max_mach;
  const bool c_low_spd = mach <= c.min_mach;
  const float alpha_deg = alpha * R2D, beta_deg = beta * R2D;
  const bool c_extreme = (alpha_deg < c.min_alpha) || (alpha_deg > c.max_alpha)
                         || (beta_deg < c.min_beta) || (beta_deg > c.max_beta);

  const bool over_max = sc >= c.max_check;
  bool off, goal;
  if (variant == HEADING) {
    off = (fabsf(wrap_pi(hdg - t1)) >= DEG5) || (fabsf(alt - t0) >= 100.0f)
          || (fabsf(vt - t2) >= 20.0f);
    goal = !off && !over_max && (sc >= c.min_check);
  } else if (variant == CONTROL) {
    off = (fabsf(wrap_pi(hdg - t1)) >= DEG5)
          || (fabsf(wrap_pi(pitch - t0)) >= DEG5) || (fabsf(vt - t2) >= 20.0f);
    goal = !off && !over_max;
  } else {
    off = (fabsf(npos - t0) >= 100.0f) || (fabsf(epos - t1) >= 100.0f)
          || (fabsf(alt - t2) >= 100.0f);
    goal = !off && !over_max;
  }
  const bool c_unreach_bad = over_max && off;
  bad = c_overload || c_low_alt || c_high_spd || c_low_spd || c_extreme || c_unreach_bad;
  done = goal;

  float d0, d1, d2, base;
  if (variant == HEADING) {
    d0 = (alt - t0) * FT / 1000.0f;
    d1 = wrap_pi(hdg - t1) / PI_F;
    d2 = (vt - t2) * FT / 340.0f;
    base = -(d0 * d0) - (d1 * d1) - (d2 * d2);
  } else if (variant == CONTROL) {
    d0 = wrap_pi(pitch - t0) / PI_F;
    d1 = wrap_pi(hdg - t1) / PI_F;
    d2 = (vt - t2) * FT / 340.0f;
    base = -(d0 * d0) - (d1 * d1) - (d2 * d2);
  } else {
    d0 = (npos - t0) * FT / 1000.0f;
    d1 = (epos - t1) * FT / 1000.0f;
    d2 = (alt - t2) * FT / 1000.0f;
    base = 0.1f * (-(d0 * d0) - (d1 * d1) - (d2 * d2));
  }
  reward = base + 200.0f * (done ? 1.0f : 0.0f) - 200.0f * (bad ? 1.0f : 0.0f);
  conds[0] = c_overload;
  conds[1] = c_low_alt;
  conds[2] = c_high_spd;
  conds[3] = c_low_spd;
  conds[4] = c_extreme;
  conds[5] = c_unreach_bad || goal;
}

}  // namespace np_task
