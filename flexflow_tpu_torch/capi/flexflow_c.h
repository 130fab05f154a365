/* The C API of the PyTorch/CUDA port (counterpart:
 * flexflow_tpu/capi/flexflow_c.h, the same surface).
 *
 * Reference analog: src/c/flexflow_c.cc / include/flexflow/flexflow_c.h, a
 * flat handle-based C mirror of the model API. This one sits above the
 * Python runtime: the library embeds CPython and drives
 * flexflow_tpu_torch, so C/C++ programs build, compile, fit and run a
 * model without writing Python. The model runs on the GPU, or on the CPU
 * when FLEXFLOW_PLATFORM=cpu is set.
 *
 * All functions return 0 on success, nonzero on error (the message from
 * flexflow_last_error). Handles are opaque integers.
 */

#ifndef FLEXFLOW_TPU_TORCH_C_H
#define FLEXFLOW_TPU_TORCH_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int64_t ff_model_t;
typedef int64_t ff_tensor_t;

/* runtime: argc/argv are parsed like the reference's FFConfig::parse_args
 * (e.g. "-b 64 --budget 16 --mesh data=4,model=2"). */
int flexflow_init(int argc, const char **argv);
void flexflow_finalize(void);
const char *flexflow_last_error(void);

int flexflow_model_create(ff_model_t *out);
void flexflow_model_destroy(ff_model_t model);

/* dims: row-major sizes; dtype: "float32", "int32", ... */
int flexflow_tensor_create(ff_model_t model, int ndims, const int64_t *dims,
                           const char *dtype, const char *name,
                           ff_tensor_t *out);

int flexflow_dense(ff_model_t model, ff_tensor_t input, int64_t out_dim,
                   const char *activation /* NULL = none */, int use_bias,
                   const char *name, ff_tensor_t *out);
int flexflow_conv2d(ff_model_t model, ff_tensor_t input, int out_channels,
                    int kernel_h, int kernel_w, int stride_h, int stride_w,
                    int padding_h, int padding_w, const char *activation,
                    int use_bias, const char *name, ff_tensor_t *out);
int flexflow_pool2d(ff_model_t model, ff_tensor_t input, int kernel_h,
                    int kernel_w, int stride_h, int stride_w, int padding_h,
                    int padding_w, const char *pool_type, const char *name,
                    ff_tensor_t *out);
int flexflow_embedding(ff_model_t model, ff_tensor_t input,
                       int64_t num_entries, int64_t out_dim,
                       const char *name, ff_tensor_t *out);
int flexflow_relu(ff_model_t model, ff_tensor_t input, const char *name,
                  ff_tensor_t *out);
int flexflow_add(ff_model_t model, ff_tensor_t a, ff_tensor_t b,
                 const char *name, ff_tensor_t *out);
int flexflow_flat(ff_model_t model, ff_tensor_t input, const char *name,
                  ff_tensor_t *out);
int flexflow_softmax(ff_model_t model, ff_tensor_t input, const char *name,
                     ff_tensor_t *out);

/* optimizer: "sgd" or "adam"; loss: "sparse_categorical_crossentropy",
 * "mean_squared_error", ... (reference loss vocabulary). */
int flexflow_model_compile(ff_model_t model, const char *optimizer, double lr,
                           const char *loss);

/* x: flattened float32 features (n_samples x feature dims of input 0);
 * y: labels (int32 for classification losses, float32 otherwise).
 * Returns the final epoch's loss via *final_loss. */
int flexflow_model_fit_f32(ff_model_t model, const float *x,
                           const int64_t *x_dims, int x_ndims,
                           const void *y, const int64_t *y_dims, int y_ndims,
                           const char *y_dtype, int epochs,
                           double *final_loss);

/* forward on float32 input; out must hold prod(out_dims) floats; the
 * output dims are returned through out_dims/out_ndims (max 8). */
int flexflow_model_forward_f32(ff_model_t model, const float *x,
                               const int64_t *x_dims, int x_ndims,
                               float *out, int64_t *out_dims, int *out_ndims);

#ifdef __cplusplus
}
#endif

#endif /* FLEXFLOW_TPU_TORCH_C_H */
